"""The reference step of the sphere/capsule pile: the generic branch.

Bodies are sorted by type (spheres in columns [0, ns), capsules after).
Each candidate pair and each terrain face gives up to two contacts: the
capsule pairs' "ends" manifold keeps both ends of a flank overlap
(merged below 1e-2 apart), sphere rows keep one.  Rows are slot-major,
``[pair slot 0 | pair slot 1 | terrain slot 0 | terrain slot 1]``; masses
split by the step's own contact count; the warm start is damped by
``warm_gamma``; the sphere block (scalar inertia, its slot-0 rows) is
solved first, then the capsule block (Mat3 inertia, every row) from the
state the sphere block left: a two-colour Gauss-Seidel of Jacobi blocks.
"""

from __future__ import annotations

import torch

from physbench.reference import capsules as C
from physbench.reference.geometry import (
    COLLISION_EPSILON, compute_basis, dot, safe_div, sphere_moving_sphere,
    triangle_moving_sphere,
)
from physbench.reference.step import (
    ENDS_PROX_SQ, PERSISTENT_THRESHOLD_SQ, broadphase, capsule_segment,
    integrate, match_warm, near_terrain, row_constraints, solve,
)


def _sel(cond, x, y):
    c = cond[..., None]
    return tuple(torch.where(c if a.dim() > cond.dim() else cond, a, b)
                 for a, b in zip(x, y))


def _neg(c):
    a, b, n, t, v = c
    return b, a, -n, t, v


def _advect(c, disp):
    a, b, n, t, v = c
    shift = disp * t[..., None]
    return a + shift, b + shift, n, t, v


def _invalid(c):
    return c[:4] + (torch.zeros_like(c[4]),)


def prune(slots, max_contacts, prox_sq):
    """The manifold of up to ``max_contacts`` points from the incoming
    contact slots (manifold.rs:72-148): the earliest time of impact
    (within COLLISION_EPSILON) restarts it, a point within ``prox_sq`` of
    a kept one replaces it when farther from the bodies' centres, others
    take a free slot.  Each slot is a dict of a, b, n, t, valid, la, lb."""
    like = slots[0]["t"]
    z3 = torch.zeros(like.shape + (3,), dtype=like.dtype, device=like.device)
    min_t = torch.full_like(like, float("inf"))
    kga, kgb, kla, klb, kn = ([z3] * max_contacts for _ in range(5))
    kga, kgb, kla, klb, kn = map(list, (kga, kgb, kla, klb, kn))
    kok = [torch.zeros_like(like, dtype=torch.bool)] * max_contacts
    m2 = lambda v: dot(v, v)
    for c in slots:
        t, ok = c["t"], c["valid"]
        earlier = ok & (t < min_t - COLLISION_EPSILON)
        later = t > min_t + COLLISION_EPSILON
        same = ok & ~earlier & ~later
        new_dist = m2(c["la"]) + m2(c["lb"])
        matched = torch.zeros_like(ok)
        new = (c["a"], c["b"], c["la"], c["lb"], c["n"])
        for k in range(max_contacts):
            close = kok[k] & ((m2(c["a"] - kga[k]) <= prox_sq)
                              | (m2(c["b"] - kgb[k]) <= prox_sq))
            hit = same & ~matched & close
            rep = (hit & ((m2(kla[k]) + m2(klb[k])) < new_dist))[..., None]
            for lst, v in zip((kga, kgb, kla, klb, kn), new):
                lst[k] = torch.where(rep, v, lst[k])
            matched = matched | hit
        append = same & ~matched
        placed = torch.zeros_like(ok)
        for k in range(max_contacts):
            free = append & ~placed & ~kok[k]
            for lst, v in zip((kga, kgb, kla, klb, kn), new):
                lst[k] = torch.where(free[..., None], v, lst[k])
            kok[k] = kok[k] | free
            placed = placed | free
        e = earlier[..., None]
        kok[0] = kok[0] | earlier
        for lst, v in zip((kga, kgb, kla, klb, kn), new):
            lst[0] = torch.where(e, v, lst[0])
        for k in range(1, max_contacts):
            kok[k] = kok[k] & ~earlier
        min_t = torch.where(earlier, t, min_t)
    count = sum(k.to(like.dtype) for k in kok)
    n_sum = sum(torch.where(k[..., None], n, 0.0) for k, n in zip(kok, kn))
    normal = n_sum * safe_div(torch.ones_like(count), count)[..., None]
    t1, t2 = compute_basis(normal)
    return dict(time=torch.where(torch.isfinite(min_t), min_t, 0.0),
                normal=normal, t1=t1, t2=t2, ra=torch.stack(kla),
                rb=torch.stack(klb), valid=torch.stack(kok))


def _slot(c, xa, da, xb, db):
    a, b, n, t, v = c
    return dict(a=a, b=b, n=n, t=t, valid=v,
                la=a - (xa + da * t[..., None]),
                lb=b - (xb + db * t[..., None]))


def pair_contacts(s, partner, ok, ns):
    """Two contact slots (K, N) of each body with its candidates."""
    x, d, r = s["x"], s["delta"], s["r"]
    ca, cd = capsule_segment(x, s["q"], s["half_h"])
    j = torch.where(ok, partner, 0).T                          # (K, N)
    n = x.shape[0]
    K = j.shape[0]
    e = lambda t: t[None].expand((K,) + t.shape)
    xa, da, ra, caa, cda = e(x), e(d), e(r), e(ca), e(cd)
    xb, db, rb, cab, cdb = x[j], d[j], r[j], ca[j], cd[j]
    v = db - da
    part_sph = s["shape_type"][j] == 0
    cols = lambda t, lo, hi: t[:, lo:hi]
    slot0, slot1 = [], []
    if ns > 0:
        c_ = lambda t: cols(t, 0, ns)
        ss = sphere_moving_sphere(c_(xa), c_(ra), c_(xb), c_(rb), c_(v))
        sc = _neg(_advect(C.contact_capsule_moving_sphere_np(
            c_(cab), c_(cdb), c_(rb), c_(xa), c_(ra), -c_(v)), c_(v)))
        s0 = _sel(c_(part_sph), ss, sc)
        slot0.append(s0)
        slot1.append(_invalid(s0))
    if ns < n:
        c_ = lambda t: cols(t, ns, n)
        cs = C.contact_capsule_moving_sphere_np(
            c_(caa), c_(cda), c_(ra), c_(xb), c_(rb), c_(v))
        cc0, cc1 = C.contact_capsule_moving_capsule_np(
            c_(caa), c_(cda), c_(ra), c_(cab), c_(cdb), c_(rb), c_(v),
            ends=True)
        slot0.append(_sel(c_(part_sph), cs, cc0))
        slot1.append(cc1[:4] + (cc1[4] & ~c_(part_sph),))
    cat = lambda parts: tuple(torch.cat(p, 1) for p in zip(*parts))
    out = []
    for c in (cat(slot0), cat(slot1)):
        c = _advect(c, da)
        c = c[:4] + (c[4] & ok.T,)
        out.append(_slot(c, xa, da, xb, db))
    return out


def terrain_contacts(s, faces, f_ok, ns):
    """Two contact slots (C, N) of each body with its candidate faces, the
    body as side a."""
    ter = s["terrain"]
    f = faces.T
    Cn, n = f.shape
    e = lambda t: t[None].expand((Cn,) + t.shape)
    x, d, r = e(s["x"]), e(s["delta"]), e(s["r"])
    ca, cd = capsule_segment(s["x"], s["q"], s["half_h"])
    ca, cd = e(ca), e(cd)
    ta, tb, tc = ter["a"][f], ter["b"][f], ter["c"][f]
    slot0, slot1 = [], []
    cols = lambda t, lo, hi: t[:, lo:hi]
    if ns > 0:
        c_ = lambda t: cols(t, 0, ns)
        c = triangle_moving_sphere(c_(ta), c_(tb), c_(tc), c_(x), c_(r),
                                   c_(d))
        slot0.append(c)
        slot1.append(_invalid(c))
    if ns < n:
        c_ = lambda t: cols(t, ns, n)
        c0, c1 = C.contact_triangle_moving_capsule_np(
            c_(ta), c_(tb), c_(tc), c_(ca), c_(cd), c_(r), c_(d))
        slot0.append(c0)
        slot1.append(c1)
    cat = lambda parts: tuple(torch.cat(p, 1) for p in zip(*parts))
    out = []
    for c in (cat(slot0), cat(slot1)):
        a, b, nn, t, v = _neg(c)
        v = v & f_ok.T
        out.append(dict(a=a, b=b, n=nn, t=t, valid=v,
                        la=a - (x + d * t[..., None]), lb=b - ter["center"]))
    return out


def _rows(man, width):
    """(S, width, N) manifold -> (S * width, N) rows, the per-pair fields
    repeated for each slot."""
    S = man["valid"].shape[0]
    rep = lambda t: t[None].expand((S,) + t.shape).reshape(
        (S * width,) + t.shape[1:])
    flat = lambda t: t.reshape((S * width,) + t.shape[2:])
    return dict(normal=rep(man["normal"]), t1=rep(man["t1"]),
                t2=rep(man["t2"]), ra=flat(man["ra"]), rb=flat(man["rb"]),
                valid=flat(man["valid"]))


def mixed_rows(s, partner, ok, cfg):
    """The contact rows of an integrated mixed state (see the module
    docstring for the layout), with their partner, key and penetration."""
    n = s["x"].shape[0]
    ns = cfg["n_sphere_rows"]
    K = partner.shape[1]
    prox = ENDS_PROX_SQ if cfg["cap_manifold"] == "ends" else \
        PERSISTENT_THRESHOLD_SQ
    pcs = pair_contacts(s, partner, ok, ns)
    faces, f_ok = near_terrain(s, s["terrain"], cfg)
    tcs = terrain_contacts(s, faces, f_ok, ns)
    pm = _rows(prune(pcs, 2, prox), K)
    tm = _rows(prune(tcs, 2, prox), faces.shape[1])
    rows = {k: torch.cat([pm[k], tm[k]]) for k in pm}
    pen = lambda cs: torch.cat([torch.where(c["valid"], -dot(
        c["b"] - c["a"], c["n"]), 0.0) for c in cs])
    rows["pen"] = torch.cat([pen(pcs), pen(tcs)])
    pr = torch.where(ok, partner, n).T
    rows["partner"] = torch.cat([pr, pr, torch.full_like(faces.T, n),
                                 torch.full_like(faces.T, n)])
    zk = torch.zeros_like(pr)
    rows["key"] = torch.cat([zk, zk + 1, faces.T, faces.T])
    return rows


def step_mixed(s, cfg, scale, schedule):
    dt = cfg["dt"]
    s = integrate(s, dt, scale, iso=False)
    n = s["x"].shape[0]
    ns = cfg["n_sphere_rows"]
    partner, ok, bp, rebuilt = broadphase(s, cfg)
    K = partner.shape[1]
    rows = mixed_rows(s, partner, ok, cfg)
    valid = rows["valid"]
    R = valid.shape[0]
    Ct = (R - 2 * K) // 2
    ter = s["terrain"]
    f = s["x"].dtype
    dev = s["x"].device
    ext = lambda t, fill=0.0: torch.cat([t, torch.full(
        (1,) + t.shape[1:], fill, dtype=t.dtype, device=dev)])
    x_end = ext(s["x"] + s["delta"])
    x_end[n] = ter["center"]
    v0, o0 = ext(s["v"]), ext(s["omega"])
    im, e_, fr = ext(s["inv_mass"]), ext(s["restitution"]), ext(s["friction"])
    I = ext(s["inv_moment"])
    cnt = torch.clamp(torch.cat([valid.sum(0).to(f),
                                 torch.ones(1, dtype=f, device=dev)]),
                      min=1.0)
    sph = list(range(K)) + list(range(2 * K, 2 * K + Ct))
    blocks = ((slice(0, ns), sph), (slice(ns, n), list(range(R))))
    (wn, wt1, wt2), matched = match_warm(s["warm"], rows["partner"],
                                         rows["key"], search=rebuilt)
    g = cfg["warm_gamma"]
    warm = (wn * g, wt1 * g, wt2 * g)
    it, inner = schedule
    eye = torch.eye(3, dtype=f, device=dev)
    v, omega = v0, o0
    acc = [torch.zeros((R, n), dtype=f, device=dev) for _ in range(3)]
    for b, (cols, rsel) in enumerate(blocks):
        if cols.start == cols.stop:
            continue
        sub = {k: t[rsel][:, cols] for k, t in rows.items()
               if k in ("normal", "t1", "t2", "ra", "rb", "valid", "partner")}
        pb = sub["partner"]
        rc = row_constraints(
            sub, x_end[cols][None], v0[cols][None], o0[cols][None],
            (im * cnt)[cols][None], (I * cnt[:, None, None])[cols][None],
            e_[cols][None], fr[cols][None],
            x_end[pb], v0[pb], o0[pb], (im * cnt)[pb],
            (I * cnt[:, None, None])[pb], e_[pb], fr[pb], dt)
        inv_I = I[:, 0, 0][:, None, None] * eye if b == 0 else I
        w = tuple(t[rsel][:, cols] for t in warm)
        v, omega, a = solve(rc, v, omega, im, inv_I, cols, None, it, inner, w)
        for full, part in zip(acc, a):
            full[torch.as_tensor(rsel, device=dev)[:, None],
                 torch.arange(n, device=dev)[cols][None, :]] = part
    hit = (matched & valid).sum() / torch.clamp(valid.sum(), min=1)
    new_warm = dict(partner=torch.where(valid, rows["partner"], -9),
                    key2=rows["key"], acc_n=acc[0], acc_t1=acc[1],
                    acc_t2=acc[2])
    out = dict(s, v=v[:n], omega=omega[:n], warm=new_warm, bp=bp)
    return out, dict(rebuilt=rebuilt, contacts=int(valid.sum()),
                     warm_hit_frac=float(hit))

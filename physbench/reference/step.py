"""The plain reference of one physics step, for the benchmark's two
configurations (the settled sphere pile and the sphere/capsule pile).

It is written from the semantics the port documents (``world.step`` and
its modules, which follow maplant/mgf's world.rs, collision.rs and
solver.rs), in plain PyTorch on (N, 3) tensors of any float dtype, with
its own neighbour search, and shares no code with the port: it imports
nothing of ``mgf_tpu_torch``.  The solver is the port's rows-Jacobi
schedule (the issue's note: the sequential Gauss-Seidel of the reference
engine gives other velocities by design), so one step of this module and
one step of the port on the same state agree to rounding.

A step, in order:

1. commit the previous sweep (``x += delta``), integrate (``q``, the world
   inverse inertia, ``v += F m^-1 dt``), sweep ``delta = v dt``;
2. the broadphase: swept fat boxes, the cadence cache's staleness test
   (rebuild every ``bp_every`` steps or when a body outruns its slack) and,
   on a rebuild, the ``max_pairs`` nearest candidates whose fattened boxes
   overlap, by the quantised distance key, ties to the larger index;
3. the narrowphase: swept contacts per candidate slot, and per body its
   ``terrain_cand`` nearest terrain faces by box distance;
4. the manifold (one slot for spheres; two for capsules, the "ends" form);
5. row constraints with mass splitting, the warm start (positional on a
   cached step, keyed on a rebuild), and ``iters`` outer iterations of
   ``inner`` Jacobi sweeps with partner velocities frozen between them;
   the sphere/capsule pile solves its sphere block, then its capsule block.

State is a dict of tensors (see :func:`state_from_world` in the harness);
everything is computed in the dtype of ``state["x"]``.
"""

from __future__ import annotations

import torch

from physbench.reference.geometry import (
    compute_basis, cross, dot, norm, safe_div, sphere_moving_sphere,
    triangle_moving_sphere,
)

PENETRATION_SLOP = 0.05     # solver.rs:276-279
BAUMGARTE = 0.2
PERSISTENT_THRESHOLD_SQ = 0.5   # manifold.rs:38
ENDS_PROX_SQ = 1.0e-4       # the capsule "ends" manifold's merge radius
KEY_LEVELS = 16383          # the candidate key's quantised distance


# ---- small helpers ----

def _mat_vec(m, v):
    return (m @ v[..., None])[..., 0]


def _qmul(p, q):
    pw, px, py, pz = p.unbind(-1)
    qw, qx, qy, qz = q.unbind(-1)
    return torch.stack([
        pw * qw - px * qx - py * qy - pz * qz,
        pw * qx + px * qw + py * qz - pz * qy,
        pw * qy - px * qz + py * qw + pz * qx,
        pw * qz + px * qy - py * qx + pz * qw], -1)


def quat_to_mat(q):
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def _qrotate(q, v):
    return _mat_vec(quat_to_mat(q), v)


def capsule_segment(x, q, half_h):
    """A capsule body's segment: start ``a`` and full axis ``d``."""
    y = torch.zeros_like(x)
    y[..., 1] = half_h
    d_half = _qrotate(q, y)
    return x - d_half, 2.0 * d_half


# ---- 1. motion ----

def integrate(s, dt, scale, iso):
    """complete_motion + integrate (physics.rs:222-269)."""
    x = s["x"] + s["delta"]
    w = s["omega"]
    wq = torch.cat([torch.zeros_like(w[:, :1]), w * dt], -1)
    q = s["q"] + 0.5 * _qmul(wq, s["q"])
    q = q / norm(q)
    if iso:
        inv_moment = s["inv_moment_body"]
    else:
        R = quat_to_mat(q)
        inv_moment = R @ s["inv_moment_body"] @ R.transpose(-1, -2)
    # the nonce scales the force the state carries on (the traffic's
    # nonces compound from step to step, as in the driver's chunk)
    force = s["force"] * scale
    v = s["v"] + force * (s["inv_mass"] * dt)[:, None]
    omega = w + _mat_vec(inv_moment, s["torque"]) * dt
    return dict(s, x=x, q=q, v=v, omega=omega, force=force,
                inv_moment=inv_moment, delta=v * dt)


# ---- 2. the broadphase ----

def body_boxes(s, cfg):
    """Each body's box (centre, half extents): a sphere's, or for a capsule
    the cube that covers it in every rotation (half extent radius + half
    its axis, bounds.rs:179-188)."""
    r = s["r"][:, None].expand_as(s["x"])
    if cfg["shape_mode"] == "spheres":
        return s["x"], r
    cap = (s["shape_type"] == 1)[:, None]
    return s["x"], torch.where(cap, r + s["half_h"][:, None], r)


def swept_boxes(c, h, delta, fatten):
    lo = torch.minimum(c - h, c + delta - h)
    hi = torch.maximum(c + h, c + delta + h)
    return (hi + lo) * 0.5, (hi - lo) * 0.5 + fatten


def neighbour_pairs(c, reach, cell):
    """Every ordered pair (i, j), i != j, whose centres lie within
    ``reach[i]`` of each other on every axis, from a uniform grid of cell
    ``cell`` >= max(reach) with no bucket limit.  Returns (i, j) index
    tensors."""
    n = c.shape[0]
    dev = c.device
    ijk = torch.floor(c / cell).to(torch.int64)
    ijk = ijk - ijk.min(0).values + 1
    span = ijk.max(0).values + 2
    key = (ijk[:, 0] * span[1] + ijk[:, 1]) * span[2] + ijk[:, 2]
    order = torch.argsort(key)
    skey = key[order]
    ii, jj = [], []
    rows = torch.arange(n, device=dev)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                nk = ((ijk[:, 0] + dx) * span[1] + ijk[:, 1] + dy) * span[2] \
                    + ijk[:, 2] + dz
                lo = torch.searchsorted(skey, nk)
                hi = torch.searchsorted(skey, nk, right=True)
                cnt = hi - lo
                m = int(cnt.max()) if n else 0
                if m == 0:
                    continue
                slot = torch.arange(m, device=dev)
                ok = slot[None, :] < cnt[:, None]
                pos = torch.clamp(lo[:, None] + slot[None, :], max=n - 1)
                j = order[pos]
                i = rows[:, None].expand_as(j)
                d = torch.abs(c[j] - c[i])
                ok = ok & (j != i) & (d <= reach[:, None, None]).all(-1)
                ii.append(i[ok])
                jj.append(j[ok])
    return torch.cat(ii), torch.cat(jj)


def in_table(c, cfg):
    """Which bodies the cell table holds: each body's cell from its box
    centre (``floor(c / cell)`` wrapped to the power-of-two dims), the
    bodies of a cell in index order, the first ``bucket_cap`` of them
    kept.  Returns (kept (N,) bool, bodies dropped)."""
    dx, dy, dz = cfg["grid_dims"]
    ijk = torch.floor(c / cfg["grid_cell"]).to(torch.int64)
    h = (((ijk[:, 0] & (dx - 1)) * dy + (ijk[:, 1] & (dy - 1))) * dz
         + (ijk[:, 2] & (dz - 1)))
    order = torch.argsort(h, stable=True)
    sh = h[order]
    rank = torch.arange(h.shape[0], device=c.device) - torch.searchsorted(
        sh, sh)
    kept = torch.empty_like(h, dtype=torch.bool)
    kept[order] = rank < cfg["bucket_cap"]
    return kept, int((~kept).sum())


def candidate_slots(c, r_eff, cfg):
    """The cached candidate list of a rebuild: per body the ``max_pairs``
    candidates nearest by the key (distance squared quantised to 16,383
    levels over (3 cell)^2, then the larger index), in ascending index
    order, -1 past the end.  A candidate is a body the cell table holds
    whose box centre lies within the largest box of the pile plus the
    body's own on every axis (the width-4 table's cull).  ``c`` and
    ``r_eff`` in the precision the keys are computed in."""
    n, K = c.shape[0], cfg["max_pairs"]
    reach = torch.max(r_eff) + r_eff
    kept, _ = in_table(c, cfg)
    i, j = neighbour_pairs(c, reach, float(torch.max(reach)) * 1.0001)
    keep = kept[j]
    i, j = i[keep], j[keep]
    d = c[j] - c[i]
    d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    inv_scale = KEY_LEVELS / (3.0 * cfg["grid_cell"]) ** 2
    qd = torch.clamp(torch.floor(d2 * inv_scale), max=KEY_LEVELS).long()
    key = ((KEY_LEVELS - qd) << 17) | j
    # the K largest keys of each row: sort by (row, key descending)
    order = torch.argsort(i * (1 << 40) - key)
    i, j, key = i[order], j[order], key[order]
    start = torch.searchsorted(i, torch.arange(n, device=c.device))
    rank = torch.arange(i.shape[0], device=c.device) - start[i]
    keep = rank < K
    partner = torch.full((n, K), n + (1 << 30), dtype=torch.int64,
                         device=c.device)
    partner[i[keep], rank[keep]] = j[keep]
    partner = torch.sort(partner, dim=1).values
    ok = partner < n
    return torch.where(ok, partner, -1), ok


def staleness(s, bp, r_eff, cfg):
    """The cadence cache's rebuild test and each body's new slack."""
    m2 = lambda v: v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1] + v[:, 2] * v[:, 2]
    x_end = s["x"] + s["delta"]
    drift = torch.sqrt(m2(x_end - bp["anchor"]))
    dmag = torch.sqrt(m2(s["delta"]))
    desired = (cfg["bp_every"] - 1) * (2.0 * dmag + 0.02)
    budget = torch.clamp(0.5 * cfg["grid_cell"] - r_eff, min=0.0)
    slack = torch.minimum(desired, budget)
    r_grow = torch.clamp(r_eff - bp["r_build"], min=0.0)
    stale = bool(torch.max(drift + r_grow - bp["slack"]) > 0.0)
    need = bp["count"] % cfg["bp_every"] == 0 or stale
    return need, slack, x_end, drift


# ---- 3. the narrowphase ----

def near_terrain(s, terrain, cfg):
    """Per body the ``terrain_cand`` faces nearest by box distance within
    its reach (radius + half height + |delta| + 0.1); among equal
    distances the lower face.  Returns (faces (N, C), valid)."""
    ta, tb, tc = terrain["a"], terrain["b"], terrain["c"]
    lo = torch.minimum(torch.minimum(ta, tb), tc)
    hi = torch.maximum(torch.maximum(ta, tb), tc)
    p = s["x"][:, None, :]
    gap = torch.clamp(torch.maximum(lo[None] - p, p - hi[None]), min=0.0)
    d2 = (gap * gap).sum(-1)
    reach = s["r"] + s["half_h"] + norm(s["delta"], keepdim=False) + 0.1
    score = torch.where(d2 <= (reach * reach)[:, None], -d2, -float("inf"))
    top, pick = torch.sort(score, dim=1, descending=True, stable=True)
    C = cfg["terrain_cand"]
    pick, ok = pick[:, :C], torch.isfinite(top[:, :C])
    # canonical order: ascending face, invalid last
    big = 1 << 28
    srt = torch.sort(torch.where(ok, pick, big), dim=1).values
    ok = srt < big
    return torch.where(ok, srt, 0), ok


def _local(a, x, delta, t):
    return a - (x + delta * t[..., None])


def sphere_pair_contacts(s, partner, ok):
    """Slot-major (K, N) contacts of each body (receiver) with its
    candidates, both swept (collision.rs:1387-1401's moving reduction)."""
    x, d, r = s["x"], s["delta"], s["r"]
    j = torch.where(ok, partner, 0).T                 # (K, N)
    xa, da, ra = x[None], d[None], r[None]
    xb, db, rb = x[j], d[j], r[j]
    xa_, da_, ra_ = (t.expand_as(u) for t, u in ((xa, xb), (da, db),
                                                  (ra, rb)))
    a, b, n, t, valid = sphere_moving_sphere(xa_, ra_, xb, rb, db - da_)
    adv = da_ * t[..., None]
    a, b = a + adv, b + adv
    valid = valid & ok.T
    return dict(a=a, b=b, n=n, t=t, valid=valid,
                la=_local(a, xa_, da_, t), lb=_local(b, xb, db, t))


def sphere_terrain_contacts(s, terrain, faces, ok):
    """(C, N) contacts of each sphere with its candidate faces, the body
    as side a (the triangle's contact negated)."""
    f = faces.T
    c = s["x"][None].expand(f.shape + (3,))
    r = s["r"][None].expand(f.shape)
    v = s["delta"][None].expand(f.shape + (3,))
    a, b, n, t, valid = triangle_moving_sphere(
        terrain["a"][f], terrain["b"][f], terrain["c"][f], c, r, v)
    a, b, n = b, a, -n
    valid = valid & ok.T
    return dict(a=a, b=b, n=n, t=t, valid=valid,
                la=_local(a, c, v, t), lb=b - terrain["center"])


def one_slot_manifold(ct):
    """A manifold of one contact: its normal, tangent basis and points."""
    ok = ct["valid"][..., None]
    nrm = torch.where(ok, ct["n"], 0.0)
    t1, t2 = compute_basis(nrm)
    return dict(normal=nrm, t1=t1, t2=t2, ra=torch.where(ok, ct["la"], 0.0),
                rb=torch.where(ok, ct["lb"], 0.0), valid=ct["valid"],
                time=torch.where(ct["valid"], ct["t"], 0.0))


# ---- 5. constraints, warm start, solve ----

def contact_bias(pen, rel_v, restitution, dt):
    b = -BAUMGARTE / dt * torch.where(pen > 0.0, 0.0, pen + PENETRATION_SLOP)
    return b + torch.where(rel_v < -1.0, -restitution * rel_v, 0.0)


def row_constraints(rows, xa, va, oa, ima, Ia, ea, fa,
                    xb, vb, ob, imb, Ib, eb, fb, dt):
    """Per-row effective masses and bias.  ``Ia``/``Ib`` are (..., 3, 3)
    (mass-split) inverse inertias; ``ima``/``imb`` mass-split inverse
    masses."""
    ra, rb, nrm = rows["ra"], rows["rb"], rows["normal"]
    pen = dot((rb + xb) - (ra + xa), nrm)
    dv = vb + cross(ob, rb) - va - cross(oa, ra)
    rel_v = dot(dv, nrm)
    restitution = torch.maximum(ea, eb)
    bias = contact_bias(pen, rel_v, restitution, dt)

    def eff(axis):
        rac = cross(ra, axis)
        rbc = cross(rb, axis)
        return safe_div(1.0, ima + dot(rac, _mat_vec(Ia, rac))
                        + imb + dot(rbc, _mat_vec(Ib, rbc)))

    return dict(rows, friction=torch.sqrt(fa * fb), bias=bias,
                nm=eff(nrm), tm1=eff(rows["t1"]), tm2=eff(rows["t2"]))


def match_warm(warm, partner_rows, key_rows, search):
    """Warm-start impulses for this step's rows: positional (the same row
    held the same partner and key) or keyed (the first previous row with
    the same partner and key)."""
    if not search:
        hit = (partner_rows == warm["partner"]) & (key_rows == warm["key2"])
        return [warm[k] * hit for k in ("acc_n", "acc_t1", "acc_t2")], hit
    R, n = partner_rows.shape
    prev_ok = warm["partner"] >= 0
    out = [torch.zeros_like(warm["acc_n"]) for _ in range(3)]
    hit = torch.zeros((R, n), dtype=torch.bool, device=partner_rows.device)
    for k in range(warm["partner"].shape[0]):
        eq = (prev_ok[k][None] & (partner_rows == warm["partner"][k][None])
              & (key_rows == warm["key2"][k][None]) & ~hit)
        for o, name in zip(out, ("acc_n", "acc_t1", "acc_t2")):
            o += torch.where(eq, warm[name][k][None], 0.0)
        hit = hit | eq
    return out, hit


def solve(rc, v, omega, inv_mass, inv_I, cols, gather_rows, iters, inner,
          warm):
    """Rows-Jacobi over the columns ``cols`` (a slice) of the (M, 3) state:
    warm impulses applied first, then ``iters`` times the partner term
    vb + ob x rb gathered from the current state (rows past
    ``gather_rows`` have a static partner: term 0) and ``inner`` sweeps,
    each row's friction (clamped by friction x its normal accumulator)
    and normal impulse from one relative velocity, applied to the row's
    body alone.  Returns (v, omega, accumulators)."""
    valid = rc["valid"]
    vf = valid.to(v.dtype)
    ima = inv_mass[cols]
    Ia = inv_I[cols]
    ra, rb, nrm, t1, t2 = rc["ra"], rc["rb"], rc["normal"], rc["t1"], rc["t2"]

    def apply(v, omega, imp):
        imp = imp * vf[..., None]
        lin = -imp.sum(0) * ima[:, None]
        ang = _mat_vec(Ia, -cross(ra, imp).sum(0))
        v = v.clone()
        omega = omega.clone()
        v[cols] = v[cols] + lin
        omega[cols] = omega[cols] + ang
        return v, omega

    acc_n, acc_t1, acc_t2 = (w * vf for w in warm)
    v, omega = apply(v, omega, t1 * acc_t1[..., None] + t2 * acc_t2[..., None]
                     + nrm * acc_n[..., None])
    part = torch.clamp(rc["partner"], max=v.shape[0] - 1)
    R = valid.shape[0]
    G = R if gather_rows is None else gather_rows
    for _ in range(iters):
        pb = part[:G]
        term = v[pb] + cross(omega[pb], rb[:G])
        if G < R:
            term = torch.cat([term, torch.zeros_like(rb[G:])], 0)
        for _ in range(inner):
            dv = term - (v[cols][None] + cross(omega[cols][None], ra))
            lam1 = -dot(dv, t1) * rc["tm1"]
            lam2 = -dot(dv, t2) * rc["tm2"]
            max_l = rc["friction"] * acc_n
            new1 = torch.minimum(torch.maximum(acc_t1 + lam1, -max_l), max_l)
            new2 = torch.minimum(torch.maximum(acc_t2 + lam2, -max_l), max_l)
            lam = rc["nm"] * (-dot(dv, nrm) + rc["bias"])
            newn = torch.clamp(acc_n + lam, min=0.0)
            imp = (t1 * (new1 - acc_t1)[..., None]
                   + t2 * (new2 - acc_t2)[..., None]
                   + nrm * (newn - acc_n)[..., None])
            acc_n, acc_t1, acc_t2 = newn, new1, new2
            v, omega = apply(v, omega, imp)
    return v, omega, (acc_n, acc_t1, acc_t2)


# ---- the step ----

def step(s, cfg, scale=1.0, schedule=None):
    """One step of ``cfg`` (a configuration file's ``engine`` block) from
    the state ``s``; ``scale`` multiplies the forces (the traffic's
    nonce), ``schedule`` = (iters, inner) the solver schedule the host
    chose.  Returns (new state, what the step found: ``rebuilt``,
    ``contacts``, ``pairs``)."""
    if cfg["shape_mode"] == "spheres":
        return _step_spheres(s, cfg, scale, schedule)
    from physbench.reference.mixed import step_mixed
    return step_mixed(s, cfg, scale, schedule)


def broadphase(s, cfg):
    """Stage 2 on the integrated state: returns (partner (N, K), ok, the
    new cache, rebuilt); a rebuilt cache also holds ``dropped``, the bodies
    its cell table could not hold.  Its decisions (the rebuild test, the cell
    table, the candidate keys) are taken in float32, the configuration's
    precision, or in the state's where that is lower: they are
    thresholds, and a float64 distance crosses them where the program's
    float32 one does not."""
    dt = s["x"].dtype
    kd = torch.float32 if torch.finfo(dt).bits > 32 else dt
    sk = {k: (v.to(kd) if isinstance(v, torch.Tensor) and v.is_floating_point()
              else v) for k, v in s.items() if k not in ("bp", "warm",
                                                           "terrain")}
    bp = {k: (v.to(kd) if isinstance(v, torch.Tensor) and v.is_floating_point()
              else v) for k, v in s["bp"].items()}
    c, h = body_boxes(sk, cfg)
    _, bh = swept_boxes(c, h, sk["delta"], cfg["fatten"])
    r_eff = bh.max(-1).values
    need, slack, x_end, _ = staleness(sk, bp, r_eff, cfg)
    if need:
        fc, fh = swept_boxes(c, h, sk["delta"], cfg["fatten"])
        fh = fh + slack[:, None]
        partner, ok = candidate_slots(fc, fh.max(-1).values, cfg)
        _, dropped = in_table(fc, cfg)
        bp = dict(partner=partner, ok=ok, anchor=x_end, count=bp["count"] + 1,
                  slack=slack, r_build=r_eff, dropped=dropped)
    else:
        bp = dict(bp, count=bp["count"] + 1)
    bp = {k: (v.to(dt) if isinstance(v, torch.Tensor) and v.is_floating_point()
              else v) for k, v in bp.items()}
    return bp["partner"], bp["ok"], bp, need


def sphere_rows(s, partner, ok, cfg):
    """The contact rows of an integrated sphere state: ``max_pairs`` pair
    rows (slot-major, one per candidate slot) then ``terrain_cand``
    terrain rows.  Returns the rows (normal, tangents, points, validity,
    penetration depth), their partner (N for the terrain) and key (0 for
    pairs, the face for terrain rows)."""
    n = s["x"].shape[0]
    pc = sphere_pair_contacts(s, partner, ok)
    faces, f_ok = near_terrain(s, s["terrain"], cfg)
    tc = sphere_terrain_contacts(s, s["terrain"], faces, f_ok)
    m_p, m_t = one_slot_manifold(pc), one_slot_manifold(tc)
    rows = {k: torch.cat([m_p[k], m_t[k]])
            for k in ("normal", "t1", "t2", "ra", "rb", "valid")}
    rows["pen"] = torch.cat([-dot(pc["b"] - pc["a"], pc["n"]),
                             -dot(tc["b"] - tc["a"], tc["n"])])
    rows["partner"] = torch.cat([
        torch.where(ok, partner, n).T,
        torch.full(faces.T.shape, n, device=faces.device,
                   dtype=torch.int64)])
    rows["key"] = torch.cat([torch.zeros_like(partner.T), faces.T])
    return rows


def _step_spheres(s, cfg, scale, schedule):
    dt = cfg["dt"]
    s = integrate(s, dt, scale, iso=True)
    n = s["x"].shape[0]
    partner, ok, bp, rebuilt = broadphase(s, cfg)
    K = partner.shape[1]
    rows = sphere_rows(s, partner, ok, cfg)
    terrain = s["terrain"]
    T = rows["valid"].shape[0] - K

    # mass splitting by the PREVIOUS step's contact count (the fused
    # path's documented approximation)
    warm = s["warm"]
    cnt = torch.clamp((warm["partner"] != -9).sum(0).to(s["x"].dtype),
                      min=1.0)
    iso = s["inv_moment"][:, 0, 0]
    x_end = s["x"] + s["delta"]
    jp = torch.where(ok, partner, 0).T                        # (K, N)
    zT = torch.zeros((T, n), dtype=s["x"].dtype, device=s["x"].device)
    cat = lambda p, t: torch.cat([p, t], 0)
    eye = torch.eye(3, dtype=s["x"].dtype, device=s["x"].device)
    xb = cat(x_end[jp], terrain["center"].expand(T, n, 3))
    vb = cat(s["v"][jp], torch.zeros((T, n, 3), dtype=zT.dtype,
                                     device=zT.device))
    ob = cat(s["omega"][jp], torch.zeros_like(vb[K:]))
    imb = cat(s["inv_mass"][jp] * cnt[jp], zT)
    ib = cat(iso[jp] * cnt[jp], zT)
    eb = cat(s["restitution"][jp], zT)
    fb = cat(s["friction"][jp], zT)
    rc = row_constraints(
        rows, x_end[None], s["v"][None], s["omega"][None],
        (s["inv_mass"] * cnt)[None], (iso * cnt)[None, :, None, None] * eye,
        s["restitution"][None], s["friction"][None],
        xb, vb, ob, imb, ib[..., None, None] * eye, eb, fb, dt)
    (wn, wt1, wt2), matched = match_warm(warm, rows["partner"], rows["key"],
                                         search=rebuilt)
    valid = rows["valid"]
    it, inner = schedule
    v, omega, acc = solve(rc, s["v"], s["omega"], s["inv_mass"],
                          iso[:, None, None] * eye, slice(0, n), K, it,
                          inner, (wn, wt1, wt2))
    hit = (matched & valid).sum() / torch.clamp(valid.sum(), min=1)
    new_warm = dict(partner=torch.where(valid, rows["partner"], -9),
                    key2=rows["key"], acc_n=acc[0], acc_t1=acc[1],
                    acc_t2=acc[2])
    out = dict(s, v=v, omega=omega, warm=new_warm, bp=bp)
    return out, dict(rebuilt=rebuilt, contacts=int(valid.sum()),
                     warm_hit_frac=float(hit))


def contact_rows(s, cfg):
    """The contact rows of the step that produced state ``s`` (its ``x``
    and ``delta`` are that step's integrated position and sweep, its cache
    the candidate list the step used)."""
    if cfg["shape_mode"] == "spheres":
        return sphere_rows(s, s["bp"]["partner"], s["bp"]["ok"], cfg)
    from physbench.reference.mixed import mixed_rows
    return mixed_rows(s, s["bp"]["partner"], s["bp"]["ok"], cfg)

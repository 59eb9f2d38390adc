"""Capsule contact routines of the plain reference, on (..., 3) tensors.

Frozen copies of the float64 NumPy routines of the port's parity oracle
(``mgf_tpu_torch/oracle.py``, lines 282-757 as of this benchmark's first
version: ``_closest_pt_seg``, ``_closest_pts_seg``, ``_qrotate``,
``_perpendicular``, ``_quat_from_arc``, ``contact_plane_moving_sphere_np``,
``contact_capsule_moving_sphere_np``, ``contact_capsule_moving_capsule_np``
and ``contact_triangle_moving_capsule_np``), which transcribe maplant/mgf's
collision.rs (the line ranges are in each docstring).  The text is the
oracle's with NumPy's namespace replaced by :class:`_Torch`, a few NumPy
calls in PyTorch's terms; the arithmetic is unchanged.
"""

from __future__ import annotations

import contextlib

import torch

from physbench.reference.geometry import (
    COLLISION_EPSILON, dot, intersect_capsule, normalize, safe_div,
)

inf = float("inf")


class _Torch:
    """The NumPy calls the oracle's routines make, on torch tensors of
    one dtype and device."""
    inf = inf

    def __init__(self, like):
        self.dtype, self.device = like.dtype, like.device

    def _t(self, v):
        return v if isinstance(v, torch.Tensor) else torch.as_tensor(
            v, dtype=self.dtype, device=self.device)

    def where(self, c, a, b):
        if not isinstance(a, torch.Tensor) and not isinstance(
                b, torch.Tensor):
            a = self._t(a) if not isinstance(a, bool) else torch.as_tensor(
                a, device=self.device)
        return torch.where(c, a, b)

    def cross(self, a, b):
        a, b = torch.broadcast_tensors(a, b)
        return torch.linalg.cross(a, b, dim=-1)

    def clip(self, x, lo, hi):
        return torch.clamp(x, lo, hi)

    def maximum(self, a, b):
        if not isinstance(b, torch.Tensor):
            return torch.clamp(a, min=b)
        return torch.maximum(a, b)

    def minimum(self, a, b):
        if not isinstance(b, torch.Tensor):
            return torch.clamp(a, max=b)
        return torch.minimum(a, b)

    def sqrt(self, x):
        return torch.sqrt(x)

    def abs(self, x):
        return torch.abs(x)

    def isfinite(self, x):
        return torch.isfinite(x)

    def zeros(self, shape, dtype=None):
        if dtype is bool:
            return torch.zeros(shape, dtype=torch.bool, device=self.device)
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    def full(self, shape, v):
        return torch.full(shape, v, dtype=self.dtype, device=self.device)

    def zeros_like(self, x):
        return torch.zeros_like(x)

    def asarray(self, v):
        return self._t(v)

    def broadcast_to(self, x, shape):
        return self._t(x).expand(shape)

    def concatenate(self, xs, axis):
        return torch.cat(xs, dim=axis)

    def stack(self, xs, axis):
        return torch.stack(xs, dim=axis)

    @property
    def linalg(self):
        return self

    def norm(self, x, axis=-1, keepdims=False):
        return torch.linalg.vector_norm(x, dim=axis, keepdim=keepdims)


def _closest_pt_seg(sa, sb, p):
    """geom.rs:590-603."""
    xp = _Torch(sa)
    ab = sb - sa
    t = dot(ab, p - sa)
    frac = xp.clip(safe_div(t, dot(ab, ab)), 0.0, 1.0)
    return sa + ab * frac[..., None]


def _closest_pts_seg(a1, b1, a2, b2):
    """geom.rs:408-444 (see geom.closest_pts_seg).  Returns (p1, p2,
    parallel)."""
    xp = _Torch(a1)
    d1 = b1 - a1
    d2 = b2 - a2
    a = dot(d1, d1)
    e = dot(d2, d2)
    r = a1 - a2
    f = dot(d2, r)
    c = dot(d1, r)
    b = dot(d1, d2)
    denom = a * e - b * b
    both_pts = a <= COLLISION_EPSILON
    seg2_pt = e <= COLLISION_EPSILON
    # relative tolerance matching geom.closest_pts_seg (r3): the exact
    # denom == 0 test lets PRECISION pick the branch for near-parallel
    # segments (f32 cancels to exactly 0, f64 keeps ~1e-17)
    parallel = (denom <= COLLISION_EPSILON * a * e) & ~both_pts & ~seg2_pt
    s_gen = xp.clip(safe_div(b * f - c * e, denom), 0.0, 1.0)
    t_un = b * s_gen + f
    s_gen = xp.where(t_un < 0.0, xp.clip(safe_div(-c, a), 0.0, 1.0), s_gen)
    s_gen = xp.where(t_un > e, xp.clip(safe_div(b - c, a), 0.0, 1.0),
                     s_gen)
    t_gen = xp.where(t_un < 0.0, 0.0,
                     xp.where(t_un > e, 1.0, safe_div(t_un, e)))
    s = xp.where(both_pts, 0.5,
                 xp.where(seg2_pt, xp.clip(safe_div(-c, a), 0.0, 1.0),
                          s_gen))
    t = xp.where(both_pts,
                 xp.where(e <= COLLISION_EPSILON, 0.5,
                          xp.clip(safe_div(f, e), 0.0, 1.0)),
                 xp.where(seg2_pt, 0.0, t_gen))
    return a1 + d1 * s[..., None], a2 + d2 * t[..., None], parallel


def _qrotate(q, v):
    """Rotate (..., 3) by (..., 4) wxyz quats."""
    xp = _Torch(q)
    w = q[..., :1]
    u = q[..., 1:]
    t = 2.0 * xp.cross(u, v)
    return v + w * t + xp.cross(u, t)


def _perpendicular(v):
    xp = _Torch(v)
    use_x = xp.abs(v[..., 0]) >= 0.57735
    a = xp.where(use_x[..., None],
                 xp.stack([v[..., 1], -v[..., 0],
                           xp.zeros_like(v[..., 0])], -1),
                 xp.stack([xp.zeros_like(v[..., 0]), v[..., 2],
                           -v[..., 1]], -1))
    return a


def _quat_from_arc(src, dst):
    """math3d.quat_from_arc (cgmath from_arc semantics)."""
    xp = _Torch(src)
    mag_avg = xp.sqrt(xp.maximum(dot(src, src) * dot(dst, dst), 0.0))
    d = dot(src, dst)
    v = xp.cross(src, dst)
    q = xp.concatenate([(mag_avg + d)[..., None], v], -1)
    qn = xp.linalg.norm(q, axis=-1, keepdims=True)
    q = xp.where(qn > 0.0, q / xp.where(qn > 0.0, qn, 1.0), q)
    anti = xp.concatenate([xp.zeros_like(d)[..., None],
                           _perpendicular(src)], -1)
    is_anti = d < -mag_avg * (1.0 - 1e-6)
    return xp.where(is_anti[..., None], anti, q)


def contact_plane_moving_sphere_np(nrm, pd, c, r, v):
    """collision.rs:521-553; nrm (…,3) unit, pd plane offset."""
    xp = _Torch(nrm)
    dist = dot(nrm, c) - pd
    over = xp.abs(dist) <= r
    a_over = c - nrm * dist[..., None]
    b_over = c - nrm * r[..., None]
    denom = dot(nrm, v)
    toward = denom * dist < 0.0
    r_signed = xp.where(dist > 0.0, r, -r)
    t = safe_div(r_signed - dist, denom)
    q = c + v * t[..., None] - nrm * r_signed[..., None]
    a = xp.where(over[..., None], a_over, q)
    b = xp.where(over[..., None], b_over, q)
    t = xp.where(over, 0.0, t)
    valid = xp.where(over, True, toward & (t <= 1.0))
    return a, b, t, valid


def contact_capsule_moving_sphere_np(ca, cd, cr, sc, sr, v):
    """collision.rs:1145-1203."""
    xp = _Torch(ca)
    r = cr + sr
    closest = _closest_pt_seg(ca, ca + cd, sc)
    d = sc - closest
    len2 = dot(d, d)
    v2 = dot(v, v)
    over = len2 <= r * r
    n_over = xp.where(len2[..., None] == 0.0, -normalize(v),
                      d * safe_div(1.0, xp.sqrt(xp.maximum(len2, 0.0)))
                      [..., None])
    a_over = closest + n_over * cr[..., None]
    b_over = sc - n_over * sr[..., None]
    valid_over = xp.where(len2 == 0.0, v2 != 0.0, True)
    t, hit = intersect_capsule(sc, v, ca, cd, r)
    b_pt = sc + v * t[..., None]
    a_pt = _closest_pt_seg(ca, ca + cd, b_pt)
    ba = normalize(b_pt - a_pt)
    q = a_pt + ba * cr[..., None]
    valid_sweep = (v2 != 0.0) & hit & (t <= 1.0)
    ov = over[..., None]
    a = xp.where(ov, a_over, q)
    b = xp.where(ov, b_over, q)
    n = xp.where(ov, n_over, ba)
    t = xp.where(over, 0.0, t)
    valid = xp.where(over, valid_over, valid_sweep)
    return a, b, n, t, valid


def contact_capsule_moving_capsule_np(a1, d1, r1, a2, d2, r2, v,
                                      ends: bool = False):
    """collision.rs:1205-1355 (mirrors collision.contact_capsule_
    moving_capsule).

    ``ends=True`` mirrors the engine's documented "ends" EXTENSION
    (collision.py contact_capsule_moving_capsule, cfg.cap_manifold):
    the parallel flank case returns the overlap interval's two ENDPOINT
    contacts instead of the single midpoint — returns (slot0, slot1)
    5-tuples; slot1 is valid only for a genuinely extended flank
    interval (same s_hi - s_lo > 1e-5 gate as the engine)."""
    xp = _Torch(a1)
    p_start, _, par_a = _closest_pts_seg(a1, a1 + d1, a2, a2 + v)
    p_end, _, par_b = _closest_pts_seg(a1, a1 + d1, a2 + d2, a2 + d2 + v)
    sub_a = xp.where(par_a[..., None], a1, p_start)
    sub_b = xp.where(par_a[..., None], a1 + d1, p_end)
    second_par_miss = (~par_a) & par_b
    q, _, axes_par = _closest_pts_seg(sub_a, sub_b, a2, a2 + d2)

    # non-parallel: Sphere(q, r1) vs moving capsule, commuted + advected
    na, nb, nn, nt, nv = contact_capsule_moving_sphere_np(
        a2, d2, r2, q, r1, -v)
    adv = v * nt[..., None]
    c_np = (nb + adv, na + adv, -nn, nt, nv)

    # parallel path
    d_mag2 = dot(d1, d1)
    t1 = safe_div(dot(a2 - a1, d1), d_mag2)
    t2 = safe_div(dot(a2 + d2 - a1, d1), d_mag2)
    swap = t1 >= t2
    t_min0 = xp.minimum(t1, t2)
    t_max0 = xp.maximum(t1, t2)
    c_a = xp.where(swap[..., None], a2 + d2, a2)
    c_d = xp.where(swap[..., None], -d2, d2)
    h = a1 - (c_a + c_d * safe_div(-t_min0, t_max0 - t_min0)[..., None])
    h_len = xp.sqrt(xp.maximum(dot(h, h), 0.0))
    r_sum = r1 + r2
    touching = h_len <= r_sum
    h_rat = safe_div(h_len - r_sum, h_len)
    v_comp = safe_div(dot(v, h), h_len * h_len)
    approaching = v_comp >= h_rat
    coll_t = safe_div(h_rat, v_comp)
    v_travel = v * coll_t[..., None]
    axis_dt = safe_div(dot(v_travel, d1), d_mag2)
    t_min = xp.where(touching, t_min0, t_min0 + axis_dt)
    t_max = xp.where(touching, t_max0, t_max0 + axis_dt)
    t_contact = xp.where(touching, 0.0, coll_t)
    b_shift = xp.where(touching[..., None], 0.0, v_travel)

    ef = contact_capsule_moving_sphere_np(a1, d1, r1, c_a + c_d, r2, v)
    en = contact_capsule_moving_sphere_np(a1, d1, r1, c_a, r2, v)

    v_ok = dot(v, v) != 0.0

    def interval_contact(s_t):
        """Flank contact at axis-1 parameter s_t of the overlap interval
        (mirrors collision.py interval_contact)."""
        o_t = safe_div(s_t - t_min, t_max - t_min)
        a_c = a1 + d1 * s_t[..., None]
        b_c = c_a + c_d * o_t[..., None] + b_shift
        ab = b_c - a_c
        ab_zero = dot(ab, ab) == 0.0
        n_ = xp.where(ab_zero[..., None], -normalize(v), normalize(ab))
        return (a_c + n_ * r1[..., None], b_c - n_ * r2[..., None],
                n_, t_contact, xp.where(ab_zero, v_ok, True))

    s_lo = xp.clip(t_min, 0.0, 1.0)
    s_hi = xp.clip(t_max, 0.0, 1.0)

    def sel(cond, x, y):
        out = []
        for xx, yy in zip(x, y):
            c = cond[..., None] if xx.ndim == yy.ndim == cond.ndim + 1 \
                else cond
            out.append(xp.where(c, xx, yy))
        return tuple(out)

    par_miss = (~touching) & (~approaching)
    mid_case = (~(t_max <= 0.0)) & (~(t_min >= 1.0))

    def par_slot(c_flank):
        c_par = sel(t_max <= 0.0, ef, sel(t_min >= 1.0, en, c_flank))
        return c_par[:4] + (c_par[4] & ~par_miss,)

    if not ends:
        out = sel(axes_par, par_slot(interval_contact((s_lo + s_hi) * 0.5)),
                  c_np)
        return out[:4] + (out[4] & ~second_par_miss,)

    slot0 = sel(axes_par, par_slot(interval_contact(s_lo)), c_np)
    slot0 = slot0[:4] + (slot0[4] & ~second_par_miss,)
    c_hi = interval_contact(s_hi)
    slot1 = c_hi[:4] + (c_hi[4] & axes_par & mid_case & ~par_miss
                        & ~second_par_miss & (s_hi - s_lo > 1e-5),)
    return slot0, slot1


def _seg_2d_intersect_np(ax, ay, bx, by, cx, cy, dx, dy):
    area = lambda px, py, qx, qy, rx, ry: ((px - rx) * (qy - ry)
                                           - (py - ry) * (qx - rx))
    a1 = area(ax, ay, bx, by, dx, dy)
    a2 = area(ax, ay, bx, by, cx, cy)
    a3 = area(cx, cy, dx, dy, ax, ay)
    a4 = a3 + a2 - a1
    hit = (a1 * a2 <= 0.0) & (a3 * a4 <= 0.0)
    return safe_div(a3, a3 - a4), hit


def _contains_tri_np(ta, tb, tc, pt):
    vv = pt - ta
    ac = tc - ta
    ab = tb - ta
    d1 = dot(ac, ac)
    d2 = dot(ac, ab)
    d3 = dot(ac, vv)
    d4 = dot(ab, ab)
    d5 = dot(ab, vv)
    den = d1 * d4 - d2 * d2
    u = safe_div(d4 * d3 - d2 * d5, den)
    w = safe_div(d1 * d5 - d2 * d3, den)
    return (u >= 0.0) & (w >= 0.0) & ((u + w) < 1.0)


def contact_triangle_moving_capsule_np(ta, tb, tc, ca, cd, cr, v):
    """collision.rs:693-1086 via collision.py's branch-free 4-stage port,
    translated to f64 numpy.  Returns two contact slots, each
    (a, b, n, t, valid), with the TRIANGLE as receiver."""
    # masked lanes legitimately produce inf*0 in unselected branches
    with contextlib.nullcontext():
        return _tri_cap_impl(ta, tb, tc, ca, cd, cr, v)


def _tri_cap_impl(ta, tb, tc, ca, cd, cr, v):
    xp = _Torch(ta)
    nrm = normalize(xp.cross(tb - ta, tc - ta))
    pd = dot(nrm, ta)
    batch = ca.shape[:-1]
    verts = [ta, tb, tc]
    edges = [(0, 1), (1, 2), (2, 0)]

    # ---- stage 1: axis piercing the face ----
    # segment-parameter pierce classification (the engine's documented
    # CORRECTNESS divergence from collision.rs:698-703 — the reference's
    # normalized-axis t tested against [0,1] is exact only for |d| == 1
    # and fabricates deep t=0 contacts otherwise; see collision.py
    # _contact_polygon_moving_capsule stage 1)
    d_hat = normalize(cd)
    non_par = xp.abs(dot(nrm, d_hat)) > COLLISION_EPSILON
    t_axis = safe_div(pd - dot(nrm, ca), dot(nrm, cd))
    q_pierce = ca + cd * t_axis[..., None]
    pierce = (non_par & (t_axis >= 0.0) & (t_axis <= 1.0)
              & _contains_tri_np(ta, tb, tc, q_pierce))
    deep_end = xp.where((dot(nrm, ca) - pd < 0.0)[..., None], ca, ca + cd)
    c_pierce = (q_pierce, deep_end - nrm * cr[..., None], nrm,
                xp.zeros(batch), pierce)

    # ---- stage 2: endpoint-sphere seeds ----
    a1_, b1_, t1_, v1_ = contact_plane_moving_sphere_np(nrm, pd, ca, cr, v)
    a2_, b2_, t2_, v2_ = contact_plane_moving_sphere_np(nrm, pd, ca + cd,
                                                        cr, v)
    cont1 = _contains_tri_np(ta, tb, tc, a1_)
    cont2 = _contains_tri_np(ta, tb, tc, a2_)
    both = v1_ & v2_
    dbl = both & (t2_ == 0.0) & ~(t2_ < t1_) & cont1 & cont2
    use2 = both & (t2_ < t1_)
    t0 = both & ~(t2_ < t1_) & (t2_ == 0.0)
    seed_valid = xp.where(both, xp.where(t0, cont1 | cont2, True),
                          v1_ | v2_)
    pick2 = xp.where(both, use2 | (t0 & ~cont1 & cont2), (~v1_) & v2_)
    p2e = pick2[..., None]
    seed_a = xp.where(p2e, a2_, a1_)
    seed_b = xp.where(p2e, b2_, b1_)
    seed_t = xp.where(pick2, t2_, t1_)
    seed_dir = xp.where(p2e, -cd, cd)
    checked = t0 & (cont1 | cont2)

    sil_v = seed_dir - nrm * safe_div(dot(seed_dir, nrm),
                                       dot(nrm, nrm))[..., None]
    n_xy = xp.broadcast_to(xp.asarray([0.0, 0.0, 1.0]), nrm.shape)
    plane_rot = _quat_from_arc(nrm, n_xy)
    pn_d = nrm * pd[..., None]
    sa3 = _qrotate(plane_rot, seed_a - pn_d)
    sb3 = _qrotate(plane_rot, seed_a + sil_v - pn_d)
    sax, say = sa3[..., 0], sa3[..., 1]
    sbx, sby = sb3[..., 0], sb3[..., 1]
    edge2d = []
    for (ia, ib) in edges:
        ea = _qrotate(plane_rot, verts[ia] - pn_d)
        eb = _qrotate(plane_rot, verts[ib] - pn_d)
        edge2d.append((ea[..., 0], ea[..., 1], eb[..., 0], eb[..., 1]))

    seed_par = xp.abs(dot(seed_dir, nrm)) < COLLISION_EPSILON
    seed_on_face = seed_valid & (checked
                                 | _contains_tri_np(ta, tb, tc, seed_a))

    t_max_a = xp.zeros(batch)
    for (eax, eay, ebx, eby) in edge2d:
        tt, hh = _seg_2d_intersect_np(sax, say, sbx, sby, eax, eay,
                                      ebx, eby)
        t_max_a = xp.where(hh & (t_max_a < tt), tt, t_max_a)
    t_max_a = xp.where(t_max_a == 0.0, 1.0, t_max_a)
    q2a = seed_a + sil_v * t_max_a[..., None]
    second_a = (q2a, q2a, nrm, seed_t, seed_on_face & seed_par)

    t_min_b = xp.full(batch, xp.inf)
    t_max_b = xp.zeros(batch)
    found_b = xp.zeros(batch, bool)
    for (eax, eay, ebx, eby) in edge2d:
        tt, hh = _seg_2d_intersect_np(sax, say, sbx, sby, eax, eay,
                                      ebx, eby)
        found_b = found_b | hh
        t_min_b = xp.where(hh & (t_min_b > tt), tt, t_min_b)
        t_max_b = xp.where(hh & (t_max_b < tt), tt, t_max_b)
    t_max_b = xp.where(t_max_b == 0.0, 1.0, t_max_b)
    stage3 = (seed_valid & ~seed_on_face & (seed_t > 0.0) & seed_par
              & found_b)
    q3a = seed_a + sil_v * t_min_b[..., None]
    q3b = seed_a + sil_v * t_max_b[..., None]

    # ---- stage 4: Minkowski-sum sweep fallback ----
    cd_mag2 = dot(cd, cd)
    cd_mag = xp.sqrt(xp.maximum(cd_mag2, 0.0))
    par_vert = [xp.zeros(batch, bool) for _ in range(3)]
    best_par_t = xp.full(batch, xp.inf)
    best_par_a = xp.zeros(batch + (3,))
    best_par_b = xp.zeros(batch + (3,))
    for (ia, ib) in edges:
        ea = verts[ia]
        eb = verts[ib]
        ab = eb - ea
        ab_cd = dot(ab, cd)
        # tolerance-classified parallel edges (see collision.py — the
        # exact-equality classification fabricates sliver-quad contacts)
        is_par = xp.abs(ab_cd) >= cd_mag * xp.sqrt(
            xp.maximum(dot(ab, ab), 0.0)) * (1.0 - 1e-6)
        par_vert[ia] = par_vert[ia] | is_par
        par_vert[ib] = par_vert[ib] | is_par
        flip = (ab_cd < 0.0)[..., None]
        e0 = xp.where(flip, eb, ea)
        e1 = xp.where(flip, ea, eb)
        m_edge = dot(ab, ab)
        i1t, i1h = intersect_capsule(ca, v, e0, e1 - e0, cr)
        i1p = ca + v * i1t[..., None]
        i1_ok = is_par & i1h & ~(i1t > xp.minimum(best_par_t, 1.0))
        tri_p1 = _closest_pt_seg(e0, e1, i1p)
        m_proj1 = dot((tri_p1 + cd) - e0, (tri_p1 + cd) - e0)
        c_t = xp.where(
            m_proj1 > m_edge,
            safe_div(m_proj1 - m_edge,
                      m_proj1 - dot(tri_p1 - e0, tri_p1 - e0)), 1.0)
        q1 = tri_p1 + cd * c_t[..., None]
        i2t, i2h = intersect_capsule(ca, v, e0, -cd, cr)
        i2p = ca + v * i2t[..., None]
        i2_ok = is_par & ~i1h & i2h & ~(i2t > xp.minimum(best_par_t, 1.0))
        cap_t = safe_div(-dot(i2p - e0, cd), cd_mag2)
        tri_p2 = _closest_pt_seg(e0, e0 - cd, i2p)
        a2p = tri_p2 + cd * cap_t[..., None]
        m_proj2 = dot((tri_p2 + cd) - e0, (tri_p2 + cd) - e0)
        b2p = xp.where((m_proj2 > m_edge)[..., None], e1, tri_p2 + cd)
        u1 = i1_ok[..., None]
        u2 = (i2_ok & ~i1_ok)[..., None]
        best_par_a = xp.where(u1, tri_p1, xp.where(u2, a2p, best_par_a))
        best_par_b = xp.where(u1, q1, xp.where(u2, b2p, best_par_b))
        best_par_t = xp.where(i1_ok, i1t,
                              xp.where(i2_ok & ~i1_ok, i2t, best_par_t))

    best_sum_t = xp.full(batch, xp.inf)
    best_sum_p = xp.zeros(batch + (3,))
    for (ia, ib) in edges:
        ea = verts[ia]
        eb = verts[ib]
        a_par = par_vert[ia]
        b_par = par_vert[ib]
        skip = a_par & b_par
        t0a, t0b, t0c = ea - cd, ea, eb
        t1a, t1b, t1c = ea - cd, eb, eb - cd
        n2 = normalize(xp.cross(t1b - t1a, t1c - t1a))
        pd2 = dot(n2, t1a)
        pa_, pb_, pt_, pv_ = contact_plane_moving_sphere_np(n2, pd2, ca,
                                                            cr, v)
        eab = eb - ea
        quad_ok = (dot(xp.cross(cd, eab), xp.cross(cd, eab))
                   > 1e-10 * cd_mag2 * dot(eab, eab))
        gate = pv_ & ~skip & quad_ok
        on_quad = (gate & (best_sum_t > pt_)
                   & (_contains_tri_np(t0a, t0b, t0c, pa_)
                      | _contains_tri_np(t1a, t1b, t1c, pb_)))
        cap_t = safe_div(-dot(pa_ - ea, cd), cd_mag2)
        q_quad = pa_ + cd * cap_t[..., None]
        best_sum_p = xp.where(on_quad[..., None], q_quad, best_sum_p)
        best_sum_t = xp.where(on_quad, pt_, best_sum_t)
        sub_gate = gate & ~on_quad
        ibt, ibh = intersect_capsule(ca, v, ea, eb - ea, cr)
        ibp = ca + v * ibt[..., None]
        ok = sub_gate & ibh & (ibt <= 1.0) & (ibt <= best_sum_t)
        qb = _closest_pt_seg(ea, eb, ibp)
        best_sum_p = xp.where(ok[..., None], qb, best_sum_p)
        best_sum_t = xp.where(ok, ibt, best_sum_t)
        itt, ith = intersect_capsule(ca, v, ea - cd, eb - ea, cr)
        itp = ca + v * itt[..., None]
        ok = sub_gate & ith & (itt <= 1.0) & (itt <= best_sum_t)
        qt = _closest_pt_seg(ea, eb, itp + cd)
        best_sum_p = xp.where(ok[..., None], qt, best_sum_p)
        best_sum_t = xp.where(ok, itt, best_sum_t)
        for vert, is_par in ((ea, a_par), (eb, b_par)):
            ivt, ivh = intersect_capsule(ca, v, vert, -cd, cr)
            ok = (sub_gate & ~is_par & ivh & (ivt <= 1.0)
                  & (ivt <= best_sum_t))
            best_sum_p = xp.where(ok[..., None],
                                  xp.broadcast_to(vert, best_sum_p.shape),
                                  best_sum_p)
            best_sum_t = xp.where(ok, ivt, best_sum_t)

    sum_wins = best_sum_t < best_par_t
    par_found = best_par_t < xp.inf

    def _near_axis(p, t):
        """see collision.py _near_axis (sliver-containment robustness)."""
        shift = v * t[..., None]
        at = _closest_pt_seg(ca + shift, ca + shift + cd, p)
        return dot(p - at, p - at) <= (cr * 1.05 + 0.02) ** 2

    def sel5(cond, x, y):
        ce = cond[..., None]
        return (xp.where(ce, x[0], y[0]), xp.where(ce, x[1], y[1]),
                xp.where(ce, x[2], y[2]), xp.where(cond, x[3], y[3]),
                xp.where(cond, x[4], y[4]))

    c4_first = sel5(sum_wins,
                    (best_sum_p, best_sum_p, nrm, best_sum_t,
                     best_sum_t < xp.inf),
                    (best_par_a, best_par_a, nrm, best_par_t, par_found))
    c4_second = (best_par_b, best_par_b, nrm, best_par_t,
                 par_found & ~sum_wins)
    safe_t = lambda t: xp.where(xp.isfinite(t), t, 0.0)
    c4_first = c4_first[:4] + (
        c4_first[4] & _near_axis(c4_first[0], safe_t(c4_first[3])),)
    c4_second = c4_second[:4] + (
        c4_second[4] & _near_axis(c4_second[0], safe_t(c4_second[3])),)
    miss = (xp.zeros(batch + (3,)), xp.zeros(batch + (3,)), nrm,
            xp.zeros(batch), xp.zeros(batch, bool))
    c3a = (q3a, q3a, nrm, seed_t, stage3)
    c3b = (q3b, q3b, nrm, seed_t, stage3)
    slot0 = sel5(stage3, c3a, c4_first)
    slot1 = sel5(stage3, c3b, c4_second)
    seedc = (seed_a, seed_b, nrm, seed_t, seed_on_face)
    slot0 = sel5(seed_on_face, seedc, slot0)
    slot1 = sel5(seed_on_face, second_a, slot1)
    cc2 = (a2_, b2_, nrm, t2_, dbl)
    cc1 = (a1_, b1_, nrm, t1_, dbl)
    slot0 = sel5(dbl, cc2, slot0)
    slot1 = sel5(dbl, cc1, slot1)
    slot0 = sel5(pierce, c_pierce, slot0)
    slot1 = sel5(pierce, miss, slot1)
    return slot0, slot1


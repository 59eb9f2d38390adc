"""f64 host-side reference step — the contact-stream parity ORACLE.

The port's own copy of ``mgf_tpu/oracle.py``: the same numpy float64 code,
routine for routine, with the Gauss-Seidel inner loop in this package's
:mod:`mgf_tpu_torch.native`.  Only the two bridges differ: :func:`from_world`
reads a port ``World`` (tensors on any device) and :func:`to_world` writes
float32 tensors back into one.  Its outputs are bit-equal to mgf_tpu's on the
same inputs.  It is a referee on the host, not an entry point of the
engine: the step it referees runs on the card.

A pure-numpy double-precision implementation of the reference's exact frame
(mgf_demo/world.rs:227-294) for sphere worlds with triangle-mesh terrain:

    complete_motion -> integrate -> terrain local_contacts (per body, per
    triangle, each contact its own constraint, world.rs:240-253) -> pair
    local_contacts (receiver i, argument j < i, world.rs:260-275) ->
    ContactConstraint::new (solver.rs:101-192) -> sequential-impulse
    Gauss-Seidel in INSERTION ORDER (solver.rs:72-78, 203-253) with the
    reference's raw-lambda friction (solver.rs:226-227).

The narrowphase mirrors collision.rs:521-553 (plane x moving sphere),
collision.rs:610-659 (polygon x moving sphere) and collision.rs:1089-1141
(sphere x moving sphere) in f64.  The Gauss-Seidel inner loop runs in native
C++ (csrc/mgf_host.cpp solve_contacts_f64).

This module referees two divergences of the engine from the reference:
solver schedule (rows-Jacobi vs sequential GS) and f32 vs f64 drift — see
PARITY.md for measured curves.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mgf_tpu_torch import native
from mgf_tpu_torch.math3d import Quat, Vec3

# solver.rs:276-279
PENETRATION_SLOP = 0.05
BAUMGARTE = 0.2
COLLISION_EPSILON = 1e-6


class OracleWorld(NamedTuple):
    """f64 SoA state for a sphere/capsule world."""
    x: np.ndarray          # (N, 3)
    q: np.ndarray          # (N, 4) wxyz orientation
    v: np.ndarray          # (N, 3)
    omega: np.ndarray      # (N, 3)
    force: np.ndarray      # (N, 3)
    inv_mass: np.ndarray   # (N,)
    inv_moment_body: np.ndarray  # (N, 3, 3) body frame
    inv_moment: np.ndarray  # (N, 3, 3) world frame (R I R^T)
    restitution: np.ndarray
    friction: np.ndarray
    shape_type: np.ndarray  # (N,) 0 sphere / 1 capsule
    r: np.ndarray          # (N,) radius
    half_h: np.ndarray     # (N,) capsule half height
    delta: np.ndarray      # (N, 3) current sweep
    tri_a: np.ndarray      # (T, 3) terrain triangles
    tri_b: np.ndarray
    tri_c: np.ndarray
    terrain_center: np.ndarray  # (3,)


def _f64(t) -> np.ndarray:
    return t.detach().cpu().double().numpy()


def from_world(world) -> OracleWorld:
    """Build an f64 oracle state from an mgf_tpu_torch World (spheres
    and/or capsules; its tensors on any device)."""
    b = world.bodies
    g = lambda v: np.stack([_f64(v.x), _f64(v.y), _f64(v.z)], axis=-1)
    m = lambda mm: np.stack(
        [np.stack([_f64(getattr(mm, k)) for k in row], axis=-1)
         for row in (("xx", "xy", "xz"), ("yx", "yy", "yz"),
                     ("zx", "zy", "zz"))], axis=-2)
    return OracleWorld(
        x=g(b.x),
        q=np.stack([_f64(b.q.w), _f64(b.q.x), _f64(b.q.y), _f64(b.q.z)],
                   axis=-1),
        v=g(b.v), omega=g(b.omega), force=g(b.force),
        inv_mass=_f64(b.inv_mass),
        inv_moment_body=m(b.inv_moment_body),
        inv_moment=m(b.inv_moment),
        restitution=_f64(b.restitution),
        friction=_f64(b.friction),
        shape_type=b.shape_type.detach().cpu().numpy().astype(np.int32),
        r=_f64(b.shape_r),
        half_h=_f64(b.shape_half_h),
        delta=g(b.delta),
        tri_a=g(world.terrain.a), tri_b=g(world.terrain.b),
        tri_c=g(world.terrain.c),
        terrain_center=np.asarray(
            [float(world.terrain_center.x), float(world.terrain_center.y),
             float(world.terrain_center.z)], np.float64))


# ---------------------------------------------------------------------------
# f64 narrowphase (vectorized over pair batches)
# ---------------------------------------------------------------------------

def _norm(v, axis=-1, keepdims=True):
    return np.sqrt(np.maximum((v * v).sum(axis, keepdims=keepdims), 0.0))


def _normalize(v):
    n = _norm(v)
    return np.where(n > 0.0, v / np.where(n > 0.0, n, 1.0), 0.0)


def _safe_div(num, den, default=0.0):
    ok = den != 0.0
    return np.where(ok, num / np.where(ok, den, 1.0), default)


def _intersect_sphere(pos, d, c, r):
    """Ray vs sphere quadratic (collision.rs:249-273), dt = inf."""
    m = pos - c
    a = (d * d).sum(-1)
    b = (m * d).sum(-1)
    cq = (m * m).sum(-1) - r * r
    discr = b * b - a * cq
    t = np.maximum(_safe_div(-b - np.sqrt(np.maximum(discr, 0.0)), a), 0.0)
    hit = (~((cq > 0.0) & (b > 0.0))) & (discr >= 0.0) & (a > 0.0)
    return t, hit


def _intersect_capsule(pos, d, ca, cd, r):
    """Ray vs capsule (collision.rs:275-359), dt = inf, vectorized."""
    m = pos - ca
    md = (m * cd).sum(-1)
    nd = (d * cd).sum(-1)
    dd = (cd * cd).sum(-1)
    nn = (d * d).sum(-1)
    mn = (m * d).sum(-1)
    a = dd * nn - nd * nd
    k = (m * m).sum(-1) - r * r

    def sphere_quad(b, c):
        discr = b * b - nn * c
        t = np.maximum(
            _safe_div(-b - np.sqrt(np.maximum(discr, 0.0)), nn), 0.0)
        ok = (~((c > 0.0) & (b > 0.0))) & (discr >= 0.0) & (nn > 0.0)
        return t, ok

    m2 = pos - (ca + cd)
    k2 = (m2 * m2).sum(-1) - r * r
    b_m2 = (m2 * d).sum(-1)
    par_b = np.where(md < 0.0, mn, b_m2)
    par_c = np.where(md < 0.0, k, k2)
    par_inside = (md >= 0.0) & (md <= dd)
    par_t, par_ok = sphere_quad(par_b, par_c)
    par_ok = par_ok & ~par_inside

    c_cyl = dd * k - md * md
    b_cyl = dd * mn - nd * md
    discr = b_cyl * b_cyl - a * c_cyl
    t_cyl = _safe_div(-b_cyl - np.sqrt(np.maximum(discr, 0.0)), a)
    gen_ok = (discr >= 0.0) & (t_cyl >= 0.0)
    axial = md + t_cyl * nd
    t_lo, lo_ok = sphere_quad(mn, k)
    lo_ok = lo_ok & ~((mn > 0.0) & (k > 0.0))
    t_hi, hi_ok = sphere_quad(b_m2, k2)
    t_gen = np.where(axial < 0.0, t_lo, np.where(axial > dd, t_hi, t_cyl))
    ok_gen = gen_ok & np.where(axial < 0.0, lo_ok,
                               np.where(axial > dd, hi_ok, True))
    parallel = np.abs(a) < COLLISION_EPSILON
    t = np.where(parallel, par_t, t_gen)
    hit = np.where(parallel, par_ok, ok_gen)
    return t, hit


def contact_sphere_moving_sphere(c1, r1, c2, r2, v):
    """collision.rs:1089-1141 in f64.  Returns (a, b, n, t, valid)."""
    r = (r1 + r2)[..., None]
    d = c2 - c1
    len2 = (d * d).sum(-1, keepdims=True)
    v2 = (v * v).sum(-1, keepdims=True)

    over = len2 <= r * r
    n_over = np.where(len2 == 0.0, -_normalize(v),
                      d * _safe_div(1.0, np.sqrt(np.maximum(len2, 0.0))))
    a_over = c1 + n_over * r1[..., None]
    b_over = c2 - n_over * r2[..., None]
    valid_over = np.where(len2[..., 0] == 0.0, v2[..., 0] != 0.0, True)

    t, hit = _intersect_sphere(c1, -v, c2, r[..., 0])
    end_c = c2 + v * t[..., None]
    ba = _normalize(end_c - c1)
    a_pt = c1 + ba * r1[..., None]
    valid_sweep = (v2[..., 0] != 0.0) & hit & (t <= 1.0)

    ov = over[..., 0]
    a = np.where(over, a_over, a_pt)
    b = np.where(over, b_over, a_pt)
    n = np.where(over, n_over, ba)
    t = np.where(ov, 0.0, t)
    valid = np.where(ov, valid_over, valid_sweep)
    return a, b, n, t, valid


def contact_triangle_moving_sphere(ta, tb, tc, c, r, v):
    """collision.rs:610-659 in f64 (plane face test, then edge capsules).
    Returns (a, b, n, t, valid) with the triangle as receiver."""
    nrm = _normalize(np.cross(tb - ta, tc - ta))
    pd = (nrm * ta).sum(-1)

    # plane x moving sphere (collision.rs:521-553)
    dist = (nrm * c).sum(-1) - pd
    over = np.abs(dist) <= r
    a_over = c - nrm * dist[..., None]
    b_over = c - nrm * r[..., None]
    denom = (nrm * v).sum(-1)
    toward = denom * dist < 0.0
    r_signed = np.where(dist > 0.0, r, -r)
    t_sw = _safe_div(r_signed - dist, denom)
    q = c + v * t_sw[..., None] - nrm * r_signed[..., None]
    pa = np.where(over[..., None], a_over, q)
    pb = np.where(over[..., None], b_over, q)
    pt = np.where(over, 0.0, t_sw)
    pvalid = np.where(over, True, toward & (t_sw <= 1.0))

    # containment (collision.rs:85-99)
    def contains(pt_):
        vv = pt_ - ta
        ac = tc - ta
        ab = tb - ta
        d1 = (ac * ac).sum(-1)
        d2 = (ac * ab).sum(-1)
        d3 = (ac * vv).sum(-1)
        d4 = (ab * ab).sum(-1)
        d5 = (ab * vv).sum(-1)
        den = d1 * d4 - d2 * d2
        u = _safe_div(d4 * d3 - d2 * d5, den)
        w = _safe_div(d1 * d5 - d2 * d3, den)
        return (u >= 0.0) & (w >= 0.0) & ((u + w) < 1.0)

    on_face = pvalid & contains(pa)

    # edge capsule raycasts
    moving = (v * v).sum(-1) != 0.0
    first_t = np.full(pt.shape, np.inf)
    tri_p = np.zeros_like(c)
    for (v1, v2) in ((ta, tb), (tb, tc), (tc, ta)):
        et, ehit = _intersect_capsule(c, v, v1, v2 - v1, r)
        better = ehit & (et <= 1.0) & (et < first_t)
        hitp = c + v * et[..., None]
        seg = v2 - v1
        tt = np.clip(_safe_div(((hitp - v1) * seg).sum(-1),
                               (seg * seg).sum(-1)), 0.0, 1.0)
        closest = v1 + seg * tt[..., None]
        tri_p = np.where(better[..., None], closest, tri_p)
        first_t = np.where(better, et, first_t)
    edge_hit = pvalid & moving & np.isfinite(first_t)

    a = np.where(on_face[..., None], pa, tri_p)
    b = np.where(on_face[..., None], pb, tri_p)
    t = np.where(on_face, pt, first_t)
    valid = np.where(on_face, pvalid, edge_hit)
    n = np.broadcast_to(nrm, a.shape)
    return a, b, n, t, valid


# ---------------------------------------------------------------------------
# f64 capsule narrowphase (mechanical translations of collision.py's
# branch-free routines, which are golden-tested against collision.rs)
# ---------------------------------------------------------------------------

def _dot(a, b):
    return (a * b).sum(-1)


def _cross(a, b):
    return np.cross(a, b)


def _closest_pt_seg(sa, sb, p):
    """geom.rs:590-603."""
    ab = sb - sa
    t = _dot(ab, p - sa)
    frac = np.clip(_safe_div(t, _dot(ab, ab)), 0.0, 1.0)
    return sa + ab * frac[..., None]


def _closest_pts_seg(a1, b1, a2, b2):
    """geom.rs:408-444 (see geom.closest_pts_seg).  Returns (p1, p2,
    parallel)."""
    d1 = b1 - a1
    d2 = b2 - a2
    a = _dot(d1, d1)
    e = _dot(d2, d2)
    r = a1 - a2
    f = _dot(d2, r)
    c = _dot(d1, r)
    b = _dot(d1, d2)
    denom = a * e - b * b
    both_pts = a <= COLLISION_EPSILON
    seg2_pt = e <= COLLISION_EPSILON
    # relative tolerance matching geom.closest_pts_seg (r3): the exact
    # denom == 0 test lets PRECISION pick the branch for near-parallel
    # segments (f32 cancels to exactly 0, f64 keeps ~1e-17)
    parallel = (denom <= COLLISION_EPSILON * a * e) & ~both_pts & ~seg2_pt
    s_gen = np.clip(_safe_div(b * f - c * e, denom), 0.0, 1.0)
    t_un = b * s_gen + f
    s_gen = np.where(t_un < 0.0, np.clip(_safe_div(-c, a), 0.0, 1.0), s_gen)
    s_gen = np.where(t_un > e, np.clip(_safe_div(b - c, a), 0.0, 1.0),
                     s_gen)
    t_gen = np.where(t_un < 0.0, 0.0,
                     np.where(t_un > e, 1.0, _safe_div(t_un, e)))
    s = np.where(both_pts, 0.5,
                 np.where(seg2_pt, np.clip(_safe_div(-c, a), 0.0, 1.0),
                          s_gen))
    t = np.where(both_pts,
                 np.where(e <= COLLISION_EPSILON, 0.5,
                          np.clip(_safe_div(f, e), 0.0, 1.0)),
                 np.where(seg2_pt, 0.0, t_gen))
    return a1 + d1 * s[..., None], a2 + d2 * t[..., None], parallel


def _qrotate(q, v):
    """Rotate (..., 3) by (..., 4) wxyz quats."""
    w = q[..., :1]
    u = q[..., 1:]
    t = 2.0 * np.cross(u, v)
    return v + w * t + np.cross(u, t)


def _perpendicular(v):
    use_x = np.abs(v[..., 0]) >= 0.57735
    a = np.where(use_x[..., None],
                 np.stack([v[..., 1], -v[..., 0],
                           np.zeros_like(v[..., 0])], -1),
                 np.stack([np.zeros_like(v[..., 0]), v[..., 2],
                           -v[..., 1]], -1))
    return a


def _quat_from_arc(src, dst):
    """math3d.quat_from_arc (cgmath from_arc semantics)."""
    mag_avg = np.sqrt(np.maximum(_dot(src, src) * _dot(dst, dst), 0.0))
    d = _dot(src, dst)
    v = np.cross(src, dst)
    q = np.concatenate([(mag_avg + d)[..., None], v], -1)
    qn = np.linalg.norm(q, axis=-1, keepdims=True)
    q = np.where(qn > 0.0, q / np.where(qn > 0.0, qn, 1.0), q)
    anti = np.concatenate([np.zeros_like(d)[..., None],
                           _perpendicular(src)], -1)
    is_anti = d < -mag_avg * (1.0 - 1e-6)
    return np.where(is_anti[..., None], anti, q)


def contact_plane_moving_sphere_np(nrm, pd, c, r, v):
    """collision.rs:521-553; nrm (…,3) unit, pd plane offset."""
    dist = _dot(nrm, c) - pd
    over = np.abs(dist) <= r
    a_over = c - nrm * dist[..., None]
    b_over = c - nrm * r[..., None]
    denom = _dot(nrm, v)
    toward = denom * dist < 0.0
    r_signed = np.where(dist > 0.0, r, -r)
    t = _safe_div(r_signed - dist, denom)
    q = c + v * t[..., None] - nrm * r_signed[..., None]
    a = np.where(over[..., None], a_over, q)
    b = np.where(over[..., None], b_over, q)
    t = np.where(over, 0.0, t)
    valid = np.where(over, True, toward & (t <= 1.0))
    return a, b, t, valid


def contact_capsule_moving_sphere_np(ca, cd, cr, sc, sr, v):
    """collision.rs:1145-1203."""
    r = cr + sr
    closest = _closest_pt_seg(ca, ca + cd, sc)
    d = sc - closest
    len2 = _dot(d, d)
    v2 = _dot(v, v)
    over = len2 <= r * r
    n_over = np.where(len2[..., None] == 0.0, -_normalize(v),
                      d * _safe_div(1.0, np.sqrt(np.maximum(len2, 0.0)))
                      [..., None])
    a_over = closest + n_over * cr[..., None]
    b_over = sc - n_over * sr[..., None]
    valid_over = np.where(len2 == 0.0, v2 != 0.0, True)
    t, hit = _intersect_capsule(sc, v, ca, cd, r)
    b_pt = sc + v * t[..., None]
    a_pt = _closest_pt_seg(ca, ca + cd, b_pt)
    ba = _normalize(b_pt - a_pt)
    q = a_pt + ba * cr[..., None]
    valid_sweep = (v2 != 0.0) & hit & (t <= 1.0)
    ov = over[..., None]
    a = np.where(ov, a_over, q)
    b = np.where(ov, b_over, q)
    n = np.where(ov, n_over, ba)
    t = np.where(over, 0.0, t)
    valid = np.where(over, valid_over, valid_sweep)
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
    p_start, _, par_a = _closest_pts_seg(a1, a1 + d1, a2, a2 + v)
    p_end, _, par_b = _closest_pts_seg(a1, a1 + d1, a2 + d2, a2 + d2 + v)
    sub_a = np.where(par_a[..., None], a1, p_start)
    sub_b = np.where(par_a[..., None], a1 + d1, p_end)
    second_par_miss = (~par_a) & par_b
    q, _, axes_par = _closest_pts_seg(sub_a, sub_b, a2, a2 + d2)

    # non-parallel: Sphere(q, r1) vs moving capsule, commuted + advected
    na, nb, nn, nt, nv = contact_capsule_moving_sphere_np(
        a2, d2, r2, q, r1, -v)
    adv = v * nt[..., None]
    c_np = (nb + adv, na + adv, -nn, nt, nv)

    # parallel path
    d_mag2 = _dot(d1, d1)
    t1 = _safe_div(_dot(a2 - a1, d1), d_mag2)
    t2 = _safe_div(_dot(a2 + d2 - a1, d1), d_mag2)
    swap = t1 >= t2
    t_min0 = np.minimum(t1, t2)
    t_max0 = np.maximum(t1, t2)
    c_a = np.where(swap[..., None], a2 + d2, a2)
    c_d = np.where(swap[..., None], -d2, d2)
    h = a1 - (c_a + c_d * _safe_div(-t_min0, t_max0 - t_min0)[..., None])
    h_len = np.sqrt(np.maximum(_dot(h, h), 0.0))
    r_sum = r1 + r2
    touching = h_len <= r_sum
    h_rat = _safe_div(h_len - r_sum, h_len)
    v_comp = _safe_div(_dot(v, h), h_len * h_len)
    approaching = v_comp >= h_rat
    coll_t = _safe_div(h_rat, v_comp)
    v_travel = v * coll_t[..., None]
    axis_dt = _safe_div(_dot(v_travel, d1), d_mag2)
    t_min = np.where(touching, t_min0, t_min0 + axis_dt)
    t_max = np.where(touching, t_max0, t_max0 + axis_dt)
    t_contact = np.where(touching, 0.0, coll_t)
    b_shift = np.where(touching[..., None], 0.0, v_travel)

    ef = contact_capsule_moving_sphere_np(a1, d1, r1, c_a + c_d, r2, v)
    en = contact_capsule_moving_sphere_np(a1, d1, r1, c_a, r2, v)

    v_ok = _dot(v, v) != 0.0

    def interval_contact(s_t):
        """Flank contact at axis-1 parameter s_t of the overlap interval
        (mirrors collision.py interval_contact)."""
        o_t = _safe_div(s_t - t_min, t_max - t_min)
        a_c = a1 + d1 * s_t[..., None]
        b_c = c_a + c_d * o_t[..., None] + b_shift
        ab = b_c - a_c
        ab_zero = _dot(ab, ab) == 0.0
        n_ = np.where(ab_zero[..., None], -_normalize(v), _normalize(ab))
        return (a_c + n_ * r1[..., None], b_c - n_ * r2[..., None],
                n_, t_contact, np.where(ab_zero, v_ok, True))

    s_lo = np.clip(t_min, 0.0, 1.0)
    s_hi = np.clip(t_max, 0.0, 1.0)

    def sel(cond, x, y):
        out = []
        for xx, yy in zip(x, y):
            c = cond[..., None] if xx.ndim == yy.ndim == cond.ndim + 1 \
                else cond
            out.append(np.where(c, xx, yy))
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
    return _safe_div(a3, a3 - a4), hit


def _contains_tri_np(ta, tb, tc, pt):
    vv = pt - ta
    ac = tc - ta
    ab = tb - ta
    d1 = _dot(ac, ac)
    d2 = _dot(ac, ab)
    d3 = _dot(ac, vv)
    d4 = _dot(ab, ab)
    d5 = _dot(ab, vv)
    den = d1 * d4 - d2 * d2
    u = _safe_div(d4 * d3 - d2 * d5, den)
    w = _safe_div(d1 * d5 - d2 * d3, den)
    return (u >= 0.0) & (w >= 0.0) & ((u + w) < 1.0)


def contact_triangle_moving_capsule_np(ta, tb, tc, ca, cd, cr, v):
    """collision.rs:693-1086 via collision.py's branch-free 4-stage port,
    translated to f64 numpy.  Returns two contact slots, each
    (a, b, n, t, valid), with the TRIANGLE as receiver."""
    # masked lanes legitimately produce inf*0 in unselected branches
    with np.errstate(invalid="ignore", divide="ignore"):
        return _tri_cap_impl(ta, tb, tc, ca, cd, cr, v)


def _tri_cap_impl(ta, tb, tc, ca, cd, cr, v):
    nrm = _normalize(np.cross(tb - ta, tc - ta))
    pd = _dot(nrm, ta)
    batch = ca.shape[:-1]
    verts = [ta, tb, tc]
    edges = [(0, 1), (1, 2), (2, 0)]

    # ---- stage 1: axis piercing the face ----
    # segment-parameter pierce classification (the engine's documented
    # CORRECTNESS divergence from collision.rs:698-703 — the reference's
    # normalized-axis t tested against [0,1] is exact only for |d| == 1
    # and fabricates deep t=0 contacts otherwise; see collision.py
    # _contact_polygon_moving_capsule stage 1)
    d_hat = _normalize(cd)
    non_par = np.abs(_dot(nrm, d_hat)) > COLLISION_EPSILON
    t_axis = _safe_div(pd - _dot(nrm, ca), _dot(nrm, cd))
    q_pierce = ca + cd * t_axis[..., None]
    pierce = (non_par & (t_axis >= 0.0) & (t_axis <= 1.0)
              & _contains_tri_np(ta, tb, tc, q_pierce))
    deep_end = np.where((_dot(nrm, ca) - pd < 0.0)[..., None], ca, ca + cd)
    c_pierce = (q_pierce, deep_end - nrm * cr[..., None], nrm,
                np.zeros(batch), pierce)

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
    seed_valid = np.where(both, np.where(t0, cont1 | cont2, True),
                          v1_ | v2_)
    pick2 = np.where(both, use2 | (t0 & ~cont1 & cont2), (~v1_) & v2_)
    p2e = pick2[..., None]
    seed_a = np.where(p2e, a2_, a1_)
    seed_b = np.where(p2e, b2_, b1_)
    seed_t = np.where(pick2, t2_, t1_)
    seed_dir = np.where(p2e, -cd, cd)
    checked = t0 & (cont1 | cont2)

    sil_v = seed_dir - nrm * _safe_div(_dot(seed_dir, nrm),
                                       _dot(nrm, nrm))[..., None]
    n_xy = np.broadcast_to(np.asarray([0.0, 0.0, 1.0]), nrm.shape)
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

    seed_par = np.abs(_dot(seed_dir, nrm)) < COLLISION_EPSILON
    seed_on_face = seed_valid & (checked
                                 | _contains_tri_np(ta, tb, tc, seed_a))

    t_max_a = np.zeros(batch)
    for (eax, eay, ebx, eby) in edge2d:
        tt, hh = _seg_2d_intersect_np(sax, say, sbx, sby, eax, eay,
                                      ebx, eby)
        t_max_a = np.where(hh & (t_max_a < tt), tt, t_max_a)
    t_max_a = np.where(t_max_a == 0.0, 1.0, t_max_a)
    q2a = seed_a + sil_v * t_max_a[..., None]
    second_a = (q2a, q2a, nrm, seed_t, seed_on_face & seed_par)

    t_min_b = np.full(batch, np.inf)
    t_max_b = np.zeros(batch)
    found_b = np.zeros(batch, bool)
    for (eax, eay, ebx, eby) in edge2d:
        tt, hh = _seg_2d_intersect_np(sax, say, sbx, sby, eax, eay,
                                      ebx, eby)
        found_b = found_b | hh
        t_min_b = np.where(hh & (t_min_b > tt), tt, t_min_b)
        t_max_b = np.where(hh & (t_max_b < tt), tt, t_max_b)
    t_max_b = np.where(t_max_b == 0.0, 1.0, t_max_b)
    stage3 = (seed_valid & ~seed_on_face & (seed_t > 0.0) & seed_par
              & found_b)
    q3a = seed_a + sil_v * t_min_b[..., None]
    q3b = seed_a + sil_v * t_max_b[..., None]

    # ---- stage 4: Minkowski-sum sweep fallback ----
    cd_mag2 = _dot(cd, cd)
    cd_mag = np.sqrt(np.maximum(cd_mag2, 0.0))
    par_vert = [np.zeros(batch, bool) for _ in range(3)]
    best_par_t = np.full(batch, np.inf)
    best_par_a = np.zeros(batch + (3,))
    best_par_b = np.zeros(batch + (3,))
    for (ia, ib) in edges:
        ea = verts[ia]
        eb = verts[ib]
        ab = eb - ea
        ab_cd = _dot(ab, cd)
        # tolerance-classified parallel edges (see collision.py — the
        # exact-equality classification fabricates sliver-quad contacts)
        is_par = np.abs(ab_cd) >= cd_mag * np.sqrt(
            np.maximum(_dot(ab, ab), 0.0)) * (1.0 - 1e-6)
        par_vert[ia] = par_vert[ia] | is_par
        par_vert[ib] = par_vert[ib] | is_par
        flip = (ab_cd < 0.0)[..., None]
        e0 = np.where(flip, eb, ea)
        e1 = np.where(flip, ea, eb)
        m_edge = _dot(ab, ab)
        i1t, i1h = _intersect_capsule(ca, v, e0, e1 - e0, cr)
        i1p = ca + v * i1t[..., None]
        i1_ok = is_par & i1h & ~(i1t > np.minimum(best_par_t, 1.0))
        tri_p1 = _closest_pt_seg(e0, e1, i1p)
        m_proj1 = _dot((tri_p1 + cd) - e0, (tri_p1 + cd) - e0)
        c_t = np.where(
            m_proj1 > m_edge,
            _safe_div(m_proj1 - m_edge,
                      m_proj1 - _dot(tri_p1 - e0, tri_p1 - e0)), 1.0)
        q1 = tri_p1 + cd * c_t[..., None]
        i2t, i2h = _intersect_capsule(ca, v, e0, -cd, cr)
        i2p = ca + v * i2t[..., None]
        i2_ok = is_par & ~i1h & i2h & ~(i2t > np.minimum(best_par_t, 1.0))
        cap_t = _safe_div(-_dot(i2p - e0, cd), cd_mag2)
        tri_p2 = _closest_pt_seg(e0, e0 - cd, i2p)
        a2p = tri_p2 + cd * cap_t[..., None]
        m_proj2 = _dot((tri_p2 + cd) - e0, (tri_p2 + cd) - e0)
        b2p = np.where((m_proj2 > m_edge)[..., None], e1, tri_p2 + cd)
        u1 = i1_ok[..., None]
        u2 = (i2_ok & ~i1_ok)[..., None]
        best_par_a = np.where(u1, tri_p1, np.where(u2, a2p, best_par_a))
        best_par_b = np.where(u1, q1, np.where(u2, b2p, best_par_b))
        best_par_t = np.where(i1_ok, i1t,
                              np.where(i2_ok & ~i1_ok, i2t, best_par_t))

    best_sum_t = np.full(batch, np.inf)
    best_sum_p = np.zeros(batch + (3,))
    for (ia, ib) in edges:
        ea = verts[ia]
        eb = verts[ib]
        a_par = par_vert[ia]
        b_par = par_vert[ib]
        skip = a_par & b_par
        t0a, t0b, t0c = ea - cd, ea, eb
        t1a, t1b, t1c = ea - cd, eb, eb - cd
        n2 = _normalize(np.cross(t1b - t1a, t1c - t1a))
        pd2 = _dot(n2, t1a)
        pa_, pb_, pt_, pv_ = contact_plane_moving_sphere_np(n2, pd2, ca,
                                                            cr, v)
        eab = eb - ea
        quad_ok = (_dot(np.cross(cd, eab), np.cross(cd, eab))
                   > 1e-10 * cd_mag2 * _dot(eab, eab))
        gate = pv_ & ~skip & quad_ok
        on_quad = (gate & (best_sum_t > pt_)
                   & (_contains_tri_np(t0a, t0b, t0c, pa_)
                      | _contains_tri_np(t1a, t1b, t1c, pb_)))
        cap_t = _safe_div(-_dot(pa_ - ea, cd), cd_mag2)
        q_quad = pa_ + cd * cap_t[..., None]
        best_sum_p = np.where(on_quad[..., None], q_quad, best_sum_p)
        best_sum_t = np.where(on_quad, pt_, best_sum_t)
        sub_gate = gate & ~on_quad
        ibt, ibh = _intersect_capsule(ca, v, ea, eb - ea, cr)
        ibp = ca + v * ibt[..., None]
        ok = sub_gate & ibh & (ibt <= 1.0) & (ibt <= best_sum_t)
        qb = _closest_pt_seg(ea, eb, ibp)
        best_sum_p = np.where(ok[..., None], qb, best_sum_p)
        best_sum_t = np.where(ok, ibt, best_sum_t)
        itt, ith = _intersect_capsule(ca, v, ea - cd, eb - ea, cr)
        itp = ca + v * itt[..., None]
        ok = sub_gate & ith & (itt <= 1.0) & (itt <= best_sum_t)
        qt = _closest_pt_seg(ea, eb, itp + cd)
        best_sum_p = np.where(ok[..., None], qt, best_sum_p)
        best_sum_t = np.where(ok, itt, best_sum_t)
        for vert, is_par in ((ea, a_par), (eb, b_par)):
            ivt, ivh = _intersect_capsule(ca, v, vert, -cd, cr)
            ok = (sub_gate & ~is_par & ivh & (ivt <= 1.0)
                  & (ivt <= best_sum_t))
            best_sum_p = np.where(ok[..., None],
                                  np.broadcast_to(vert, best_sum_p.shape),
                                  best_sum_p)
            best_sum_t = np.where(ok, ivt, best_sum_t)

    sum_wins = best_sum_t < best_par_t
    par_found = best_par_t < np.inf

    def _near_axis(p, t):
        """see collision.py _near_axis (sliver-containment robustness)."""
        shift = v * t[..., None]
        at = _closest_pt_seg(ca + shift, ca + shift + cd, p)
        return _dot(p - at, p - at) <= (cr * 1.05 + 0.02) ** 2

    def sel5(cond, x, y):
        ce = cond[..., None]
        return (np.where(ce, x[0], y[0]), np.where(ce, x[1], y[1]),
                np.where(ce, x[2], y[2]), np.where(cond, x[3], y[3]),
                np.where(cond, x[4], y[4]))

    c4_first = sel5(sum_wins,
                    (best_sum_p, best_sum_p, nrm, best_sum_t,
                     best_sum_t < np.inf),
                    (best_par_a, best_par_a, nrm, best_par_t, par_found))
    c4_second = (best_par_b, best_par_b, nrm, best_par_t,
                 par_found & ~sum_wins)
    safe_t = lambda t: np.where(np.isfinite(t), t, 0.0)
    c4_first = c4_first[:4] + (
        c4_first[4] & _near_axis(c4_first[0], safe_t(c4_first[3])),)
    c4_second = c4_second[:4] + (
        c4_second[4] & _near_axis(c4_second[0], safe_t(c4_second[3])),)
    miss = (np.zeros(batch + (3,)), np.zeros(batch + (3,)), nrm,
            np.zeros(batch), np.zeros(batch, bool))
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


def compute_basis(n):
    """geom.rs:1138-1145 friction tangent basis, f64, vectorized."""
    zero = np.zeros_like(n[..., 0])
    use_x = np.abs(n[..., 0]) >= 0.57735
    b = np.where(use_x[..., None],
                 np.stack([n[..., 1], -n[..., 0], zero], -1),
                 np.stack([zero, n[..., 2], -n[..., 1]], -1))
    b = _normalize(b)
    return b, np.cross(n, b)


# ---------------------------------------------------------------------------
# the oracle frame
# ---------------------------------------------------------------------------

class Constraints(NamedTuple):
    body_a: np.ndarray
    body_b: np.ndarray
    ra: np.ndarray
    rb: np.ndarray
    normal: np.ndarray
    t1: np.ndarray
    t2: np.ndarray
    friction: np.ndarray
    bias: np.ndarray
    normal_mass: np.ndarray
    tm1: np.ndarray
    tm2: np.ndarray


def _build_constraints(w, x_end, v, omega, ia, ib, ra, rb, n, dt,
                       static_b):
    """ContactConstraint::new (solver.rs:101-192) in f64, vectorized.
    ``static_b`` marks rows whose body_b is the terrain static."""
    imass = w.inv_mass
    I = w.inv_moment
    zero3 = np.zeros((3, 3))
    xa = x_end[ia]
    va = v[ia]
    oa = omega[ia]
    ima = imass[ia]
    Ia = I[ia]
    if static_b is None:
        xb = x_end[ib]
        vb = v[ib]
        ob = omega[ib]
        imb = imass[ib]
        Ib = I[ib]
        restitution = np.maximum(w.restitution[ia], w.restitution[ib])
        friction = np.sqrt(w.friction[ia] * w.friction[ib])
    else:
        xb = np.broadcast_to(w.terrain_center, xa.shape)
        vb = np.zeros_like(va)
        ob = np.zeros_like(oa)
        imb = np.zeros_like(ima)
        Ib = np.broadcast_to(zero3, Ia.shape)
        restitution = w.restitution[ia]          # max(rest, 0)
        friction = np.zeros_like(ima)            # sqrt(f * 0)

    t1, t2 = compute_basis(n)
    ra_cn = np.cross(ra, n)
    rb_cn = np.cross(rb, n)
    pen = (((rb + xb) - (ra + xa)) * n).sum(-1)
    dv = vb + np.cross(ob, rb) - va - np.cross(oa, ra)
    rel_v = (dv * n).sum(-1)
    bias = (-BAUMGARTE / dt * np.where(pen > 0.0, 0.0,
                                       pen + PENETRATION_SLOP)
            + np.where(rel_v < -1.0, -restitution * rel_v, 0.0))

    def eff_mass(ta_, tb_):
        mv = lambda M, vv: np.einsum("...ij,...j->...i", M, vv)
        den = (ima + (ta_ * mv(Ia, ta_)).sum(-1)
               + imb + (tb_ * mv(Ib, tb_)).sum(-1))
        return _safe_div(1.0, den)

    normal_mass = eff_mass(ra_cn, rb_cn)
    tm1 = eff_mass(np.cross(ra, t1), np.cross(rb, t1))
    tm2 = eff_mass(np.cross(ra, t2), np.cross(rb, t2))
    if static_b is not None:
        # terrain impulses sink into the extra static solver row
        ib = np.full_like(ia, w.x.shape[0])
    return Constraints(ia.astype(np.int32), ib.astype(np.int32), ra, rb,
                       n, t1, t2, friction, bias, normal_mass, tm1, tm2)


def to_world(ow: OracleWorld, template):
    """Write the oracle state back into an f32 World, on the template's
    device (its other fields, caches included, are the template's)."""
    dev = template.bodies.x.x.device
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                    dtype=torch.float32, device=dev)
    v3 = lambda a: Vec3(f32(a[:, 0]), f32(a[:, 1]), f32(a[:, 2]))
    bodies = template.bodies._replace(
        x=v3(ow.x), v=v3(ow.v), omega=v3(ow.omega), delta=v3(ow.delta),
        q=Quat(f32(ow.q[:, 0]), f32(ow.q[:, 1]), f32(ow.q[:, 2]),
               f32(ow.q[:, 3])))
    return template._replace(bodies=bodies)


def _qmul(p, q):
    pw, px, py, pz = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return np.stack([
        pw * qw - px * qx - py * qy - pz * qz,
        pw * qx + px * qw + py * qz - pz * qy,
        pw * qy - px * qz + py * qw + pz * qx,
        pw * qz + px * qy - py * qx + pz * qw], axis=-1)


def _quat_to_mat(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1)], axis=-2)


def oracle_step(w: OracleWorld, dt: float = 1.0 / 60.0, iters: int = 20,
                mgf_friction: bool = True, cap_manifold: str = "mid"):
    """One reference frame.  Returns (new_world, contact_records) where
    ``contact_records`` is a dict of arrays describing every solved contact
    (kind 0 = terrain, 1 = pair) in constraint insertion order.  ``j`` for
    terrain rows encodes triangle * 2 + slot (capsules emit two slots).
    ``slot`` records the pair manifold slot (always 0 except capsule pairs
    under ``cap_manifold="ends"`` — the engine's two-endpoint flank
    extension, cfg.cap_manifold; collision.rs:1331-1354 is the single-
    midpoint "mid" default)."""
    n = w.x.shape[0]
    x = w.x + w.delta                       # complete_motion
    # integrate (physics.rs:222-253): q += 0.5 (0, w dt) q, normalized;
    # world inverse inertia R I^-1 R^T; v += F m^-1 dt
    wq = np.concatenate([np.zeros((n, 1)), w.omega * dt], axis=-1)
    q = w.q + 0.5 * _qmul(wq, w.q)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    R = _quat_to_mat(q)
    inv_moment = R @ w.inv_moment_body @ np.swapaxes(R, -1, -2)
    w = w._replace(q=q, inv_moment=inv_moment)
    v = w.v + w.force * (w.inv_mass * dt)[:, None]
    omega = w.omega.copy()
    delta = v * dt
    x_end = x + delta

    # collider reconstruction (compound.rs:217-228): capsule a/d from (x,q)
    is_cap = w.shape_type == 1
    d_half = _qrotate(q, np.broadcast_to(
        np.asarray([0.0, 1.0, 0.0]), (n, 3)) * w.half_h[:, None])
    cap_a = x - d_half
    cap_d = 2.0 * d_half

    cons = []
    rec = dict(kind=[], i=[], j=[], t=[], n=[], pa=[], pb=[], slot=[])

    def emit(kind, bi, jid, a, b, nn, t, slot=0):
        rec["kind"].append(np.full(len(bi), kind, np.int32))
        rec["i"].append(bi.astype(np.int32))
        rec["j"].append(jid.astype(np.int32))
        rec["t"].append(t)
        rec["n"].append(nn)
        rec["pa"].append(a)
        rec["pb"].append(b)
        rec["slot"].append(np.full(len(bi), slot, np.int32))

    # ---- terrain: per body, per triangle (world.rs:240-253) ----
    T = w.tri_a.shape[0]
    if T > 0:
        bi = np.repeat(np.arange(n), T)
        ti = np.tile(np.arange(T), n)
        ta, tb_, tc = w.tri_a[ti], w.tri_b[ti], w.tri_c[ti]
        parts = []
        sph_rows = np.nonzero(~is_cap[bi])[0]
        if len(sph_rows):
            s = sph_rows
            a, b, nn, t, valid = contact_triangle_moving_sphere(
                ta[s], tb_[s], tc[s], x[bi[s]], w.r[bi[s]], delta[bi[s]])
            parts.append((s, 0, a, b, nn, t, valid))
        cap_rows = np.nonzero(is_cap[bi])[0]
        if len(cap_rows):
            s = cap_rows
            slot0, slot1 = contact_triangle_moving_capsule_np(
                ta[s], tb_[s], tc[s], cap_a[bi[s]], cap_d[bi[s]],
                w.r[bi[s]], delta[bi[s]])
            for k, (a, b, nn, t, valid) in enumerate((slot0, slot1)):
                parts.append((s, k, a, b, nn, t, valid))
        # flip chain nets a = body point, b = terrain point, n = -tri n;
        # constraint order: body asc, tri asc, slot asc
        order = []
        for (s, slot, a, b, nn, t, valid) in parts:
            keep = np.nonzero(valid)[0]
            for k in keep:
                order.append((bi[s[k]], ti[s[k]], slot, s[k],
                              b[k], a[k], -nn[k], t[k]))
        order.sort(key=lambda e: (e[0], e[1], e[2]))
        if order:
            bi_o = np.asarray([e[0] for e in order])
            ji_o = np.asarray([e[1] * 2 + e[2] for e in order])
            a_o = np.stack([e[4] for e in order])
            b_o = np.stack([e[5] for e in order])
            n_o = np.stack([e[6] for e in order])
            t_o = np.asarray([e[7] for e in order])
            ra = a_o - (x[bi_o] + delta[bi_o] * t_o[:, None])
            rb = b_o - w.terrain_center
            cons.append(_build_constraints(w, x_end, v, omega, bi_o, bi_o,
                                           ra, rb, n_o, dt, static_b=True))
            emit(0, bi_o, ji_o, a_o, b_o, n_o, t_o)

    # ---- pairs: receiver i, argument j < i (world.rs:260-275) ----
    reach = (w.r + 2.0 * w.half_h
             + np.linalg.norm(delta, axis=-1))
    ii, jj = np.nonzero(
        np.linalg.norm(x[:, None] - x[None, :], axis=-1)
        <= reach[:, None] + reach[None, :] + 1e-6)
    keep = jj < ii
    ii, jj = ii[keep], jj[keep]
    if len(ii):
        # Moving x Moving reduction (collision.rs:1387-1401): receiver i
        # static, argument j moving at delta_j - delta_i, advect by
        # delta_i * t
        vrel = delta[jj] - delta[ii]
        ti_cap = is_cap[ii]
        tj_cap = is_cap[jj]
        a = np.zeros((len(ii), 3))
        b = np.zeros((len(ii), 3))
        nn = np.zeros((len(ii), 3))
        t = np.zeros(len(ii))
        valid = np.zeros(len(ii), bool)

        def put(mask_rows, res):
            a[mask_rows], b[mask_rows], nn[mask_rows] = res[0], res[1], \
                res[2]
            t[mask_rows], valid[mask_rows] = res[3], res[4]

        m_ss = np.nonzero(~ti_cap & ~tj_cap)[0]
        if len(m_ss):
            s = m_ss
            ra_, rb_, rn, rt, rv = contact_sphere_moving_sphere(
                x[ii[s]], w.r[ii[s]], x[jj[s]], w.r[jj[s]], vrel[s])
            put(s, (ra_, rb_, rn, rt, rv))
        # ends slot-1 buffers (cap_manifold="ends": capsule-pair flank
        # intervals emit a second endpoint contact)
        a1s = np.zeros((len(ii), 3))
        b1s = np.zeros((len(ii), 3))
        n1s = np.zeros((len(ii), 3))
        t1s = np.zeros(len(ii))
        valid1 = np.zeros(len(ii), bool)
        m_cc = np.nonzero(ti_cap & tj_cap)[0]
        if len(m_cc):
            s = m_cc
            res = contact_capsule_moving_capsule_np(
                cap_a[ii[s]], cap_d[ii[s]], w.r[ii[s]],
                cap_a[jj[s]], cap_d[jj[s]], w.r[jj[s]], vrel[s],
                ends=cap_manifold == "ends")
            if cap_manifold == "ends":
                slot0, slot1 = res
                put(s, slot0)
                a1s[s], b1s[s], n1s[s] = slot1[0], slot1[1], slot1[2]
                t1s[s], valid1[s] = slot1[3], slot1[4]
                # emulate the engine pruner's proximity merge at the ends
                # threshold (manifold_prox_sq == 1e-4): a slot-1 endpoint
                # within 1e-2 of slot 0's is merged away by the engine
                d0a = np.sum((a1s[s] - slot0[0]) ** 2, axis=-1)
                d0b = np.sum((b1s[s] - slot0[1]) ** 2, axis=-1)
                valid1[s] = slot1[4] & (~slot0[4]
                                        | ((d0a > 1e-4) & (d0b > 1e-4)))
            else:
                put(s, res)
        m_cs = np.nonzero(ti_cap & ~tj_cap)[0]
        if len(m_cs):
            s = m_cs
            put(s, contact_capsule_moving_sphere_np(
                cap_a[ii[s]], cap_d[ii[s]], w.r[ii[s]],
                x[jj[s]], w.r[jj[s]], vrel[s]))
        m_sc = np.nonzero(~ti_cap & tj_cap)[0]
        if len(m_sc):
            # sphere receiver vs moving capsule: commuted capsule-vs-
            # sphere at -v, advected by v t, flipped (collision.rs:1143)
            s = m_sc
            ca_, cb_, cn, ct, cv = contact_capsule_moving_sphere_np(
                cap_a[jj[s]], cap_d[jj[s]], w.r[jj[s]],
                x[ii[s]], w.r[ii[s]], -vrel[s])
            adv = vrel[s] * ct[..., None]
            put(s, (cb_ + adv, ca_ + adv, -cn, ct, cv))

        ii0, jj0 = ii, jj
        adv = delta[ii] * t[..., None]
        a = a + adv
        b = b + adv
        keep = np.nonzero(valid)[0]
        ii, jj = ii[keep], jj[keep]
        a, b, nn, t = a[keep], b[keep], nn[keep], t[keep]
        ra = a - (x[ii] + delta[ii] * t[:, None])
        rb = b - (x[jj] + delta[jj] * t[:, None])
        cons.append(_build_constraints(w, x_end, v, omega, ii, jj, ra, rb,
                                       nn, dt, static_b=None))
        emit(1, ii, jj, a, b, nn, t)
        if cap_manifold == "ends" and valid1.any():
            # second flank-endpoint contacts (engine manifold slot 1),
            # advected and constrained exactly like slot 0
            k1 = np.nonzero(valid1)[0]
            i1, j1 = ii0[k1], jj0[k1]
            adv1 = delta[i1] * t1s[k1][..., None]
            a1 = a1s[k1] + adv1
            b1 = b1s[k1] + adv1
            n1 = n1s[k1]
            t1_ = t1s[k1]
            ra1 = a1 - (x[i1] + delta[i1] * t1_[:, None])
            rb1 = b1 - (x[j1] + delta[j1] * t1_[:, None])
            cons.append(_build_constraints(w, x_end, v, omega, i1, j1,
                                           ra1, rb1, n1, dt, static_b=None))
            emit(1, i1, j1, a1, b1, n1, t1_, slot=1)

    records = {k: (np.concatenate(vals) if vals else np.zeros((0,)))
               for k, vals in rec.items()}

    if cons:
        con = Constraints(*[np.ascontiguousarray(np.concatenate(f))
                            for f in zip(*cons)])
        # one extra static row sinks terrain impulses
        v_ext = np.concatenate([v, np.zeros((1, 3))])
        o_ext = np.concatenate([omega, np.zeros((1, 3))])
        im_ext = np.concatenate([w.inv_mass, np.zeros(1)])
        I_ext = np.concatenate([w.inv_moment, np.zeros((1, 3, 3))])
        v_new, o_new = native.solve_contacts_f64(
            v_ext, o_ext, im_ext, I_ext, con.body_a, con.body_b, con.ra,
            con.rb, con.normal, con.t1, con.t2, con.friction, con.bias,
            con.normal_mass, con.tm1, con.tm2, iters, mgf_friction)
        v, omega = v_new[:n], o_new[:n]

    return w._replace(x=x, v=v, omega=omega, delta=delta), records

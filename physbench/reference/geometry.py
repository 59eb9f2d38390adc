"""Contact routines of the plain reference, on (..., 3) float tensors.

Frozen copies, in plain PyTorch, of the float64 NumPy routines of the
port's parity oracle (``mgf_tpu_torch/oracle.py`` as of this benchmark's
first version): ``_intersect_sphere``, ``_intersect_capsule``,
``contact_sphere_moving_sphere``, ``contact_triangle_moving_sphere``,
``contact_plane_moving_sphere_np``, ``contact_capsule_moving_sphere_np``,
``contact_capsule_moving_capsule_np`` and ``_tri_cap_impl``, which in turn
transcribe maplant/mgf's collision.rs (the line ranges are given at each
routine).  NumPy's ``where``/``sum``/``cross`` became their torch
equivalents; nothing else changed.  They belong to the benchmark and do
not follow later edits of the port.

Every routine returns ``(a, b, n, t, valid)``: the two contact points,
the normal, the time of impact in [0, 1] and a validity mask.
"""

from __future__ import annotations

import torch

COLLISION_EPSILON = 1e-6


def dot(a, b):
    return (a * b).sum(-1)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def norm(v, keepdim=True):
    return torch.sqrt(torch.clamp((v * v).sum(-1, keepdim=keepdim), min=0.0))


def normalize(v):
    n = norm(v)
    return torch.where(n > 0.0, v / torch.where(n > 0.0, n, 1.0), 0.0)


def safe_div(num, den, default=0.0):
    ok = den != 0.0
    return torch.where(ok, num / torch.where(ok, den, 1.0), default)


def _sq(v):
    return torch.sqrt(torch.clamp(v, min=0.0))


def intersect_sphere(pos, d, c, r):
    """Ray vs sphere (collision.rs:249-273), dt = inf."""
    m = pos - c
    a = dot(d, d)
    b = dot(m, d)
    cq = dot(m, m) - r * r
    discr = b * b - a * cq
    t = torch.clamp(safe_div(-b - _sq(discr), a), min=0.0)
    hit = (~((cq > 0.0) & (b > 0.0))) & (discr >= 0.0) & (a > 0.0)
    return t, hit


def intersect_capsule(pos, d, ca, cd, r):
    """Ray vs capsule (collision.rs:275-359), dt = inf."""
    m = pos - ca
    md = dot(m, cd)
    nd = dot(d, cd)
    dd = dot(cd, cd)
    nn = dot(d, d)
    mn = dot(m, d)
    a = dd * nn - nd * nd
    k = dot(m, m) - r * r

    def sphere_quad(b, c):
        discr = b * b - nn * c
        t = torch.clamp(safe_div(-b - _sq(discr), nn), min=0.0)
        ok = (~((c > 0.0) & (b > 0.0))) & (discr >= 0.0) & (nn > 0.0)
        return t, ok

    m2 = pos - (ca + cd)
    k2 = dot(m2, m2) - r * r
    b_m2 = dot(m2, d)
    par_b = torch.where(md < 0.0, mn, b_m2)
    par_c = torch.where(md < 0.0, k, k2)
    par_inside = (md >= 0.0) & (md <= dd)
    par_t, par_ok = sphere_quad(par_b, par_c)
    par_ok = par_ok & ~par_inside

    c_cyl = dd * k - md * md
    b_cyl = dd * mn - nd * md
    discr = b_cyl * b_cyl - a * c_cyl
    t_cyl = safe_div(-b_cyl - _sq(discr), a)
    gen_ok = (discr >= 0.0) & (t_cyl >= 0.0)
    axial = md + t_cyl * nd
    t_lo, lo_ok = sphere_quad(mn, k)
    lo_ok = lo_ok & ~((mn > 0.0) & (k > 0.0))
    t_hi, hi_ok = sphere_quad(b_m2, k2)
    t_gen = torch.where(axial < 0.0, t_lo,
                        torch.where(axial > dd, t_hi, t_cyl))
    ok_gen = gen_ok & torch.where(axial < 0.0, lo_ok,
                                  torch.where(axial > dd, hi_ok, True))
    parallel = torch.abs(a) < COLLISION_EPSILON
    t = torch.where(parallel, par_t, t_gen)
    hit = torch.where(parallel, par_ok, ok_gen)
    return t, hit


def sphere_moving_sphere(c1, r1, c2, r2, v):
    """Sphere vs swept sphere (collision.rs:1089-1141)."""
    r = (r1 + r2)[..., None]
    d = c2 - c1
    len2 = dot(d, d)[..., None]
    v2 = dot(v, v)
    over = len2 <= r * r
    n_over = torch.where(len2 == 0.0, -normalize(v),
                         d * safe_div(1.0, _sq(len2)))
    a_over = c1 + n_over * r1[..., None]
    b_over = c2 - n_over * r2[..., None]
    valid_over = torch.where(len2[..., 0] == 0.0, v2 != 0.0, True)

    t, hit = intersect_sphere(c1, -v, c2, r[..., 0])
    end_c = c2 + v * t[..., None]
    ba = normalize(end_c - c1)
    a_pt = c1 + ba * r1[..., None]
    valid_sweep = (v2 != 0.0) & hit & (t <= 1.0)

    ov = over[..., 0]
    return (torch.where(over, a_over, a_pt), torch.where(over, b_over, a_pt),
            torch.where(over, n_over, ba), torch.where(ov, 0.0, t),
            torch.where(ov, valid_over, valid_sweep))


def contains_triangle(ta, tb, tc, p):
    """collision.rs:85-99."""
    vv = p - ta
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


def triangle_moving_sphere(ta, tb, tc, c, r, v):
    """Triangle vs swept sphere (collision.rs:610-659): the plane's face
    test, then the edges as capsules.  The triangle is the receiver."""
    nrm = normalize(cross(tb - ta, tc - ta))
    pd = dot(nrm, ta)
    dist = dot(nrm, c) - pd
    over = torch.abs(dist) <= r
    a_over = c - nrm * dist[..., None]
    b_over = c - nrm * r[..., None]
    denom = dot(nrm, v)
    toward = denom * dist < 0.0
    r_signed = torch.where(dist > 0.0, r, -r)
    t_sw = safe_div(r_signed - dist, denom)
    q = c + v * t_sw[..., None] - nrm * r_signed[..., None]
    pa = torch.where(over[..., None], a_over, q)
    pb = torch.where(over[..., None], b_over, q)
    pt = torch.where(over, 0.0, t_sw)
    pvalid = torch.where(over, True, toward & (t_sw <= 1.0))
    on_face = pvalid & contains_triangle(ta, tb, tc, pa)

    moving = dot(v, v) != 0.0
    first_t = torch.full_like(pt, float("inf"))
    tri_p = torch.zeros_like(c)
    for v1, v2 in ((ta, tb), (tb, tc), (tc, ta)):
        seg = v2 - v1
        et, ehit = intersect_capsule(c, v, v1, seg, r)
        better = ehit & (et <= 1.0) & (et < first_t)
        hitp = c + v * et[..., None]
        tt = torch.clamp(safe_div(dot(hitp - v1, seg), dot(seg, seg)),
                         0.0, 1.0)
        closest = v1 + seg * tt[..., None]
        tri_p = torch.where(better[..., None], closest, tri_p)
        first_t = torch.where(better, et, first_t)
    edge_hit = pvalid & moving & torch.isfinite(first_t)

    a = torch.where(on_face[..., None], pa, tri_p)
    b = torch.where(on_face[..., None], pb, tri_p)
    t = torch.where(on_face, pt, first_t)
    valid = torch.where(on_face, pvalid, edge_hit)
    return a, b, nrm.expand_as(a), t, valid


def compute_basis(n):
    """Tangent basis of a unit normal (geom.rs:1138-1145, Box2D's)."""
    zero = torch.zeros_like(n[..., 0])
    use_x = torch.abs(n[..., 0]) >= 0.57735
    b = torch.where(use_x[..., None],
                    torch.stack([n[..., 1], -n[..., 0], zero], -1),
                    torch.stack([zero, n[..., 2], -n[..., 1]], -1))
    b = normalize(b)
    return b, cross(n, b)

"""Narrowphase collision detection on tensors: overlap and containment
tests, ray/segment intersections, and the continuous contacts of spheres and
capsules against each other and against planes, triangles and rectangles.

Counterpart of ``mgf_tpu.collision`` (reference: collision.rs); the
generic convex contact (GJK + EPA) is in ``gjk``.  Every routine evaluates
all of its cases and
selects, returns fixed-shape results with validity masks and is batched
over any tensor shape; routines that can emit two contacts (capsule vs
triangle, parallel capsules under ``ends``) return a Contact with a leading
slot axis of size 2.  A case not taken may hold inf or NaN; it only ever
passes through ``torch.where``, never through a product with a float mask.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from mgf_tpu_torch.geom import (
    AABB, OBB, RECTANGLE_EDGES, TRIANGLE_EDGES, Capsule, Plane, Rectangle,
    Segment, Sphere, Triangle, closest_pt_segment, closest_pts_seg,
    plane_from_rectangle, plane_from_triangle, rectangle_vertices,
    segment_of_capsule, triangle_vertices,
)
from mgf_tpu_torch.math3d import (
    COLLISION_EPSILON, Quat, Vec3, clamp, cross, dot, magnitude, magnitude2,
    qrotate, quat_from_arc, safe_div, safe_normalize, safe_sqrt, tree_map,
    vabs, vzeros_like, where_vec,
)

_INF = float("inf")


class Intersection(NamedTuple):
    """Particle-vs-volume hit (collision.rs:151-157)."""
    p: Vec3
    t: torch.Tensor
    hit: torch.Tensor


class Contact(NamedTuple):
    """Continuous contact (collision.rs:431-442); t in [0,1], t == 0 is a
    resting / already-overlapping contact."""
    a: Vec3
    b: Vec3
    n: Vec3
    t: torch.Tensor
    valid: torch.Tensor


class LocalContact(NamedTuple):
    """Contact with per-body local points (collision.rs:1410-1419)."""
    local_a: Vec3
    local_b: Vec3
    contact: Contact


def contact_miss(like: Vec3) -> Contact:
    z = vzeros_like(like)
    s = torch.zeros_like(like.x)
    return Contact(a=z, b=z, n=z, t=s, valid=torch.zeros_like(s,
                                                              dtype=torch.bool))


def contact_neg(c: Contact) -> Contact:
    """Negate normal + swap points (collision.rs:444-456)."""
    return Contact(a=c.b, b=c.a, n=-c.n, t=c.t, valid=c.valid)


def contact_select(cond, c1: Contact, c2: Contact) -> Contact:
    return Contact(a=where_vec(cond, c1.a, c2.a),
                   b=where_vec(cond, c1.b, c2.b),
                   n=where_vec(cond, c1.n, c2.n),
                   t=torch.where(cond, c1.t, c2.t),
                   valid=torch.where(cond, c1.valid, c2.valid))


def contact_advect(c: Contact, disp: Vec3) -> Contact:
    """Shift both contact points by ``disp``."""
    return c._replace(a=c.a + disp, b=c.b + disp)


def contact_stack(contacts) -> Contact:
    """Stack Contacts along a new leading slot axis."""
    return tree_map(lambda *xs: torch.stack(xs, dim=0), *contacts)


def contact_stack_bcast(contacts) -> Contact:
    """:func:`contact_stack` for Contacts whose fields may still differ in
    shape by broadcasting (a self side of shape (1, N) against a partner
    side of shape (K, N)): every field goes to the common shape first."""
    leaves = []
    for c in contacts:
        leaves.extend([*c.a, *c.b, *c.n, c.t, c.valid])
    shape = torch.broadcast_shapes(*(x.shape for x in leaves))
    return contact_stack([tree_map(lambda x: x.expand(shape), c)
                          for c in contacts])


# Overlaps (collision.rs:17-68) ---------------------------------------------

def overlap_aabb_aabb(a: AABB, b: AABB):
    """collision.rs:22-28."""
    d = vabs(a.c - b.c)
    s = a.r + b.r
    return (d.x <= s.x) & (d.y <= s.y) & (d.z <= s.z)


def overlap_sphere_aabb(s: Sphere, box: AABB):
    """collision.rs:37-61: squared distance from the center to the box."""
    def axis(c, bc, br):
        lo = c - (bc - br)
        hi = c - (bc + br)
        return torch.where(lo < 0.0, lo, torch.where(hi > 0.0, hi, 0.0))
    ex = axis(s.c.x, box.c.x, box.r.x)
    ey = axis(s.c.y, box.c.y, box.r.y)
    ez = axis(s.c.z, box.c.z, box.r.z)
    return ex * ex + ey * ey + ez * ez <= s.r * s.r


def overlap_sphere_sphere(a: Sphere, b: Sphere):
    """collision.rs:63-68."""
    r = a.r + b.r
    return magnitude2(b.c - a.c) <= r * r


# Contains (collision.rs:74-147) --------------------------------------------

def contains_plane_pt(p: Plane, pt: Vec3):
    """collision.rs:79-83."""
    return _approx_eq(dot(p.n, pt), p.d)


def contains_triangle_pt(t: Triangle, pt: Vec3):
    """collision.rs:85-99 (u >= 0, v >= 0, u+v < 1)."""
    v = pt - t.a
    ac = t.c - t.a
    ab = t.b - t.a
    d1 = dot(ac, ac)
    d2 = dot(ac, ab)
    d3 = dot(ac, v)
    d4 = dot(ab, ab)
    d5 = dot(ab, v)
    denom = d1 * d4 - d2 * d2
    u = safe_div(d4 * d3 - d2 * d5, denom)
    w = safe_div(d1 * d5 - d2 * d3, denom)
    return (u >= 0.0) & (w >= 0.0) & ((u + w) < 1.0)


def _approx_eq(a, b, eps=COLLISION_EPSILON):
    """cgmath relative_eq!: absolute OR relative epsilon check."""
    diff = torch.abs(a - b)
    return (diff <= eps) | (diff <= eps * torch.maximum(torch.abs(a),
                                                        torch.abs(b)))


def contains_rectangle_pt(r: Rectangle, pt: Vec3):
    """collision.rs:102-111."""
    n = cross(r.u0, r.u1)
    on_plane = _approx_eq(dot(pt, n), dot(n, r.c))
    return (on_plane & (torch.abs(dot(pt, r.u0)) <= r.e0)
            & (torch.abs(dot(pt, r.u1)) <= r.e1))


def contains_aabb_pt(box: AABB, pt: Vec3):
    """collision.rs:114-119."""
    d = vabs(box.c - pt)
    return (d.x <= box.r.x) & (d.y <= box.r.y) & (d.z <= box.r.z)


def contains_sphere_pt(s: Sphere, pt: Vec3):
    """collision.rs:122-125."""
    return magnitude2(pt - s.c) <= s.r * s.r


def contains_aabb_aabb(a: AABB, b: AABB):
    """collision.rs:129-134."""
    return contains_aabb_pt(a, b.c + b.r) & contains_aabb_pt(a, b.c - b.r)


def contains_sphere_sphere(a: Sphere, b: Sphere):
    """collision.rs:139-147."""
    r = a.r - b.r
    return (a.r >= b.r) & (magnitude2(b.c - a.c) <= r * r)


# Intersects: particle (ray dt=inf / segment dt=1) vs volumes
# (collision.rs:164-373) -----------------------------------------------------

def intersect_plane(pos: Vec3, d: Vec3, dt, plane: Plane) -> Intersection:
    """collision.rs:169-184."""
    denom = dot(plane.n, d)
    t = safe_div(plane.d - dot(plane.n, pos), denom)
    hit = (denom != 0.0) & (t > 0.0) & (t <= dt)
    return Intersection(p=pos + d * t, t=t, hit=hit)


def intersect_triangle(pos, d, dt, tri: Triangle) -> Intersection:
    """Particle vs polygon = plane hit + containment (collision.rs:186-200)."""
    inter = intersect_plane(pos, d, dt, plane_from_triangle(tri))
    return inter._replace(hit=inter.hit & contains_triangle_pt(tri, inter.p))


def intersect_rectangle(pos, d, dt, rect: Rectangle) -> Intersection:
    inter = intersect_plane(pos, d, dt, plane_from_rectangle(rect))
    return inter._replace(hit=inter.hit & contains_rectangle_pt(rect,
                                                                inter.p))


def intersect_aabb(pos: Vec3, d: Vec3, dt, box: AABB) -> Intersection:
    """Slab test (collision.rs:202-236)."""
    def axis(p, dd, c, r):
        par = torch.abs(dd) < COLLISION_EPSILON
        out = par & (torch.abs(p - c) > r)
        ood = safe_div(torch.ones_like(dd), dd)
        t1 = (c - r - p) * ood
        t2 = (c + r - p) * ood
        lo = torch.where(par, -_INF, torch.minimum(t1, t2))
        hi = torch.where(par, _INF, torch.maximum(t1, t2))
        return lo, hi, out
    lx, hx, ox = axis(pos.x, d.x, box.c.x, box.r.x)
    ly, hy, oy = axis(pos.y, d.y, box.c.y, box.r.y)
    lz, hz, oz = axis(pos.z, d.z, box.c.z, box.r.z)
    t_min = torch.clamp(torch.maximum(torch.maximum(lx, ly), lz), min=0.0)
    t_max = torch.minimum(torch.minimum(hx, hy), hz)
    hit = (~(ox | oy | oz)) & (t_min <= t_max) & (t_min <= dt)
    return Intersection(p=pos + d * t_min, t=t_min, hit=hit)


def intersect_obb(pos, d, dt, box: OBB) -> Intersection:
    """collision.rs:238-247: rotate the particle into the box frame, with
    the reference's use of ``o.q`` directly (geom.rs:829-837)."""
    p2 = qrotate(box.q, pos - box.c) + box.c
    d2 = qrotate(box.q, d)
    return intersect_aabb(p2, d2, dt, AABB(c=box.c, r=box.r))


def intersect_sphere(pos: Vec3, d: Vec3, dt, s: Sphere) -> Intersection:
    """collision.rs:249-273."""
    m = pos - s.c
    a = magnitude2(d)
    b = dot(m, d)
    c = magnitude2(m) - s.r * s.r
    discr = b * b - a * c
    t = torch.clamp(safe_div(-b - safe_sqrt(discr), a), min=0.0)
    hit = (~((c > 0.0) & (b > 0.0))) & (discr >= 0.0) & (a > 0.0) & (t <= dt)
    return Intersection(p=pos + d * t, t=t, hit=hit)


def _fma(a, b, c):
    """a * b + c rounded once to float32: a multiply fused with the add that
    reads it, as XLA fuses them when it compiles mgf_tpu's step for the CPU.
    The product of two float32 values is exact in float64, so the float64
    sum rounds as the fused operation does (but for a double rounding, in
    ~2^-29 of the cases)."""
    return torch.addcmul(c, a.double(), b).float()


def _dot_fma(a: Vec3, b: Vec3):
    """``dot`` as XLA compiles it: (ax*bx + ay*by) + az*bz with each add
    fused with a multiply (the first operand's, where both are)."""
    return _fma(a.z, b.z, _fma(a.x, b.x, a.y * b.y))


def intersect_capsule(pos: Vec3, d: Vec3, dt, cap: Capsule) -> Intersection:
    """Ray/segment vs capsule (collision.rs:275-359): infinite-cylinder
    quadratic clamped to the endcap spheres; the axis-parallel case
    degenerates to a sphere test at the nearest endcap.

    The quadratics cancel large terms (dd * k and md * md are ~2e5 for a
    sphere 0.5 from the demo box's 28-unit floor diagonal), so their
    float32 rounding moves t by up to ~2e-4 there.  Every multiply that
    feeds an add is fused with it as XLA fuses them in mgf_tpu's compiled
    step (``_fma``), so the port's t rounds as mgf_tpu's does (equal in
    over 99 % of random lanes, within 1e-6 in the rest)."""
    m = pos - cap.a
    md = _dot_fma(m, cap.d)
    nd = _dot_fma(d, cap.d)
    dd = _dot_fma(cap.d, cap.d)
    nn = _dot_fma(d, d)
    mn = _dot_fma(m, d)
    a = _fma(dd, nn, -(nd * nd))
    k = _fma(-cap.r, cap.r, _dot_fma(m, m))

    def sphere_quad(b, c):
        discr = _fma(b, b, -(nn * c))
        t = torch.clamp(safe_div(-b - safe_sqrt(discr), nn), min=0.0)
        ok = (~((c > 0.0) & (b > 0.0))) & (discr >= 0.0) & (nn > 0.0)
        return t, ok

    # parallel path (collision.rs:288-313)
    m2 = pos - (cap.a + cap.d)
    k2 = _fma(-cap.r, cap.r, _dot_fma(m2, m2))
    b_m2 = _dot_fma(m2, d)
    par_b = torch.where(md < 0.0, mn, b_m2)
    par_c = torch.where(md < 0.0, k, k2)
    par_inside = (md >= 0.0) & (md <= dd)
    par_t, par_ok = sphere_quad(par_b, par_c)
    par_ok = par_ok & ~par_inside & (par_t <= dt)

    # general path (collision.rs:314-357)
    c_cyl = _fma(dd, k, -(md * md))
    b_cyl = _fma(dd, mn, -(nd * md))
    discr = _fma(b_cyl, b_cyl, -(a * c_cyl))
    t_cyl = safe_div(-b_cyl - safe_sqrt(discr), a)
    gen_ok = (discr >= 0.0) & (t_cyl >= 0.0)

    axial = _fma(t_cyl, nd, md)
    t_lo, lo_ok = sphere_quad(mn, k)
    lo_ok = lo_ok & ~((mn > 0.0) & (k > 0.0))
    t_hi, hi_ok = sphere_quad(b_m2, k2)

    t_gen = torch.where(axial < 0.0, t_lo,
                        torch.where(axial > dd, t_hi, t_cyl))
    ok_gen = gen_ok & torch.where(axial < 0.0, lo_ok,
                                  torch.where(axial > dd, hi_ok, True))
    ok_gen = ok_gen & (t_gen <= dt)

    parallel = torch.abs(a) < COLLISION_EPSILON
    t = torch.where(parallel, par_t, t_gen)
    hit = torch.where(parallel, par_ok, ok_gen)
    return Intersection(p=Vec3(*(_fma(dc, t, pc) for dc, pc in zip(d, pos))),
                        t=t, hit=hit)


def intersect_moving_sphere(pos, d, dt, s: Sphere, v: Vec3) -> Intersection:
    """collision.rs:361-373: identical to a capsule along the sweep."""
    return intersect_capsule(pos, d, dt, Capsule(a=s.c, d=v, r=s.r))


def contact_plane_moving_sphere(p: Plane, s: Sphere, v: Vec3) -> Contact:
    """Plane vs swept sphere (collision.rs:521-553)."""
    dist = dot(p.n, s.c) - p.d
    over = torch.abs(dist) <= s.r
    c_over = Contact(a=s.c - p.n * dist, b=s.c - p.n * s.r, n=p.n,
                     t=torch.zeros_like(dist), valid=torch.ones_like(over))
    denom = dot(p.n, v)
    toward = denom * dist < 0.0
    r_signed = torch.where(dist > 0.0, s.r, -s.r)
    t = safe_div(r_signed - dist, denom)
    q = s.c + v * t - p.n * r_signed
    c_sweep = Contact(a=q, b=q, n=p.n, t=t, valid=toward & (t <= 1.0))
    return contact_select(over, c_over, c_sweep)


def contact_plane_moving_capsule(p: Plane, cap: Capsule, v: Vec3) -> Contact:
    """Plane vs swept capsule (collision.rs:555-605).

    As in the JAX package, the axis-plane crossing uses the actual segment
    parameter (the reference measures it along the NORMALIZED axis but
    tests [0, 1] and evaluates the crossing point with the UNNORMALIZED
    axis, exact only for |d| == 1)."""
    d_hat = safe_normalize(cap.d)
    denom = dot(p.n, d_hat)
    parallel = torch.abs(denom) < COLLISION_EPSILON
    t_axis = safe_div(p.d - dot(p.n, cap.a), dot(p.n, cap.d))

    center = where_vec(parallel, cap.a + cap.d * 0.5,
                       where_vec(t_axis > 1.0, cap.a + cap.d, cap.a))

    pierce = (~parallel) & (t_axis >= 0.0) & (t_axis <= 1.0)
    q = cap.a + cap.d * t_axis
    dist_a = dot(p.n, cap.a) - p.d
    deep_end = where_vec(dist_a < 0.0, cap.a, cap.a + cap.d)
    c_pierce = Contact(a=q, b=deep_end - p.n * cap.r, n=p.n,
                       t=torch.zeros_like(t_axis),
                       valid=torch.ones_like(pierce))

    c_sphere = contact_plane_moving_sphere(p, Sphere(c=center, r=cap.r), v)
    return contact_select(pierce, c_pierce, c_sphere)


def contact_sphere_moving_sphere(s1: Sphere, s2: Sphere, v: Vec3) -> Contact:
    """Sphere vs swept sphere (collision.rs:1089-1141)."""
    r = s1.r + s2.r
    d = s2.c - s1.c
    len2 = magnitude2(d)

    over = len2 <= r * r
    v_ok = magnitude2(v) != 0.0
    n_over = where_vec(len2 == 0.0, -safe_normalize(v),
                       d * safe_div(1.0, safe_sqrt(len2), 0.0))
    c_over = Contact(a=s1.c + n_over * s1.r, b=s2.c - n_over * s2.r,
                     n=n_over, t=torch.zeros_like(len2),
                     valid=(len2 != 0.0) | v_ok)

    inter = intersect_sphere(s1.c, -v, _INF, Sphere(c=s2.c, r=r))
    end_c = s2.c + v * inter.t
    ba = safe_normalize(end_c - s1.c)
    a_pt = s1.c + ba * s1.r
    c_sweep = Contact(a=a_pt, b=a_pt, n=ba, t=inter.t,
                      valid=v_ok & inter.hit & (inter.t <= 1.0))
    return contact_select(over, c_over, c_sweep)


def contact_capsule_moving_sphere(cap: Capsule, s: Sphere, v: Vec3) -> Contact:
    """Capsule vs swept sphere (collision.rs:1145-1203)."""
    r = cap.r + s.r
    closest = closest_pt_segment(segment_of_capsule(cap), s.c)
    d = s.c - closest
    len2 = magnitude2(d)

    over = len2 <= r * r
    v_ok = magnitude2(v) != 0.0
    n_over = where_vec(len2 == 0.0, -safe_normalize(v),
                       d * safe_div(1.0, safe_sqrt(len2), 0.0))
    c_over = Contact(a=closest + n_over * cap.r, b=s.c - n_over * s.r,
                     n=n_over, t=torch.zeros_like(len2),
                     valid=(len2 != 0.0) | v_ok)

    inter = intersect_capsule(s.c, v, _INF, Capsule(a=cap.a, d=cap.d, r=r))
    b_pt = s.c + v * inter.t
    a_pt = closest_pt_segment(segment_of_capsule(cap), b_pt)
    ba = safe_normalize(b_pt - a_pt)
    q = a_pt + ba * cap.r
    c_sweep = Contact(a=q, b=q, n=ba, t=inter.t,
                      valid=v_ok & inter.hit & (inter.t <= 1.0))
    return contact_select(over, c_over, c_sweep)


def contact_sphere_moving_capsule(s: Sphere, cap: Capsule, v: Vec3) -> Contact:
    """Sphere vs swept capsule (commuted, collision.rs:1143 + 1368-1382):
    static capsule vs sphere moving at -v, advected by v*t, flipped."""
    c = contact_capsule_moving_sphere(cap, s, -v)
    c = contact_advect(c, v * c.t)
    return contact_neg(c)


def contact_capsule_moving_capsule(c1: Capsule, c2: Capsule,
                                   v: Vec3, ends: bool = False) -> Contact:
    """Capsule vs swept capsule (collision.rs:1205-1355).

    Non-parallel axes reduce to a representative sphere on c1's axis;
    parallel axes use interval overlap along the shared direction, colliding
    at the ends (sphere reductions) or flank-to-flank at the interval
    midpoint.

    ``ends=True`` is the JAX package's documented EXTENSION over the
    reference: the parallel flank case emits the overlap interval's two
    ENDPOINT contacts (leading slot axis 2) instead of the single midpoint
    (collision.rs:1331-1354).  All other cases return [contact, invalid].
    """
    seg1 = segment_of_capsule(c1)

    p_start, _, par_a = closest_pts_seg(seg1, Segment(a=c2.a, b=c2.a + v))
    p_end, _, par_b = closest_pts_seg(
        seg1, Segment(a=c2.a + c2.d, b=c2.a + c2.d + v))
    # reference: first parallel -> full segment; only second parallel -> miss
    sub_a = where_vec(par_a, c1.a, p_start)
    sub_b = where_vec(par_a, c1.a + c1.d, p_end)
    second_par_miss = (~par_a) & par_b

    q, _, axes_par = closest_pts_seg(Segment(a=sub_a, b=sub_b),
                                     segment_of_capsule(c2))

    # non-parallel: Sphere(q, r1) vs the moving capsule (collision.rs:1224-1232)
    c_nonpar = contact_sphere_moving_capsule(Sphere(c=q, r=c1.r), c2, v)

    # parallel path (collision.rs:1234-1354)
    d_mag2 = magnitude2(c1.d)
    t1 = safe_div(dot(c2.a - c1.a, c1.d), d_mag2)
    t2 = safe_div(dot(c2.a + c2.d - c1.a, c1.d), d_mag2)
    swap = t1 >= t2
    t_min0 = torch.minimum(t1, t2)
    t_max0 = torch.maximum(t1, t2)
    c_a = where_vec(swap, c2.a + c2.d, c2.a)
    c_d = where_vec(swap, -c2.d, c2.d)

    h = c1.a - (c_a + c_d * safe_div(-t_min0, t_max0 - t_min0))
    h_len = magnitude(h)
    r_sum = c1.r + c2.r
    touching = h_len <= r_sum

    h_rat = safe_div(h_len - r_sum, h_len)
    v_comp = safe_div(dot(v, h), h_len * h_len)
    approaching = v_comp >= h_rat
    coll_t = safe_div(h_rat, v_comp)
    v_travel = v * coll_t
    axis_dt = safe_div(dot(v_travel, c1.d), d_mag2)

    t_min = torch.where(touching, t_min0, t_min0 + axis_dt)
    t_max = torch.where(touching, t_max0, t_max0 + axis_dt)
    t_contact = torch.where(touching, 0.0, coll_t)
    b_shift = where_vec(touching, vzeros_like(v_travel), v_travel)

    c_end_far = contact_capsule_moving_sphere(c1, Sphere(c=c_a + c_d,
                                                         r=c2.r), v)
    c_end_near = contact_capsule_moving_sphere(c1, Sphere(c=c_a, r=c2.r), v)

    v_ok = magnitude2(v) != 0.0

    def interval_contact(s_t):
        """Flank contact at axis-1 parameter s_t of the overlap interval."""
        o_t = safe_div(s_t - t_min, t_max - t_min)
        a_c = c1.a + c1.d * s_t
        b_c = c_a + c_d * o_t + b_shift
        ab = b_c - a_c
        ab_zero = magnitude2(ab) == 0.0
        n_ = where_vec(ab_zero, -safe_normalize(v), safe_normalize(ab))
        return Contact(a=a_c + n_ * c1.r, b=b_c - n_ * c2.r, n=n_,
                       t=t_contact, valid=~ab_zero | v_ok)

    s_lo = clamp(t_min, 0.0, 1.0)
    s_hi = clamp(t_max, 0.0, 1.0)
    c_mid = interval_contact((s_lo + s_hi) * 0.5)

    par_miss = (~touching) & (~approaching)
    mid_case = (~(t_max <= 0.0)) & (~(t_min >= 1.0))

    def par_slot(c_flank):
        c_par = contact_select(
            t_max <= 0.0, c_end_far,
            contact_select(t_min >= 1.0, c_end_near, c_flank))
        return c_par._replace(valid=c_par.valid & ~par_miss)

    if not ends:
        out = contact_select(axes_par, par_slot(c_mid), c_nonpar)
        return out._replace(valid=out.valid & ~second_par_miss)

    slot0 = contact_select(axes_par, par_slot(interval_contact(s_lo)),
                           c_nonpar)
    slot0 = slot0._replace(valid=slot0.valid & ~second_par_miss)
    c_hi = interval_contact(s_hi)
    # second endpoint only for a genuinely extended flank interval
    slot1 = c_hi._replace(
        valid=(c_hi.valid & axes_par & mid_case & ~par_miss
               & ~second_par_miss & (s_hi - s_lo > 1e-5)))
    return contact_stack_bcast([slot0, slot1])


def _contact_polygon_moving_sphere(plane: Plane, verts, edges, contains_fn,
                                   s: Sphere, v: Vec3) -> Contact:
    """Polygon vs swept sphere: face first, then the earliest edge hit
    (collision.rs:610-659)."""
    pc = contact_plane_moving_sphere(plane, s, v)
    on_face = pc.valid & contains_fn(pc.a)

    moving = magnitude2(v) != 0.0
    first_t = torch.full_like(pc.t, _INF)
    tri_p = vzeros_like(s.c)
    for (ia, ib) in edges:
        v1 = verts[ia]
        v2 = verts[ib]
        inter = intersect_capsule(s.c, v, _INF,
                                  Capsule(a=v1, d=v2 - v1, r=s.r))
        better = inter.hit & (inter.t <= 1.0) & (inter.t < first_t)
        pt = closest_pt_segment(Segment(a=v1, b=v2), inter.p)
        tri_p = where_vec(better, pt, tri_p)
        first_t = torch.where(better, inter.t, first_t)
    edge_hit = pc.valid & moving & (first_t < _INF)
    c_edge = Contact(a=tri_p, b=tri_p, n=plane.n, t=first_t, valid=edge_hit)
    return contact_select(on_face, pc, c_edge)


def contact_triangle_moving_sphere(tri: Triangle, s: Sphere,
                                   v: Vec3) -> Contact:
    return _contact_polygon_moving_sphere(
        plane_from_triangle(tri), triangle_vertices(tri), TRIANGLE_EDGES,
        lambda p: contains_triangle_pt(tri, p), s, v)


def contact_rectangle_moving_sphere(rect: Rectangle, s: Sphere,
                                    v: Vec3) -> Contact:
    return _contact_polygon_moving_sphere(
        plane_from_rectangle(rect), rectangle_vertices(rect),
        RECTANGLE_EDGES, lambda p: contains_rectangle_pt(rect, p), s, v)


def _signed_2d_tri_area(ax, ay, bx, by, cx, cy):
    return (ax - cx) * (by - cy) - (ay - cy) * (bx - cx)


def _seg_2d_intersect(ax, ay, bx, by, cx, cy, dx, dy):
    """2D segment intersection (collision.rs:667-688); returns (t along ab,
    hit)."""
    a1 = _signed_2d_tri_area(ax, ay, bx, by, dx, dy)
    a2 = _signed_2d_tri_area(ax, ay, bx, by, cx, cy)
    a3 = _signed_2d_tri_area(cx, cy, dx, dy, ax, ay)
    a4 = a3 + a2 - a1
    hit = (a1 * a2 <= 0.0) & (a3 * a4 <= 0.0)
    t = safe_div(a3, a3 - a4)
    return t, hit


def _contact_polygon_moving_capsule(plane: Plane, verts, edges, contains_fn,
                                    cap: Capsule, v: Vec3) -> Contact:
    """Polygon x Moving<Capsule>: up to TWO contacts (slot axis 2).

    Four stages, mirroring collision.rs:693-1086:
      1. capsule axis already piercing the face          -> 1 contact, t=0
      2. endpoint-sphere seeds on the plane + silhouette -> 1-2 contacts
      3. parallel-silhouette interval                    -> 2 contacts
      4. Minkowski-sum edge sweep fallback               -> 1-2 contacts

    The JAX package's three divergences from the reference are kept: the
    stage-1 pierce test on the actual segment parameter, the relative
    edge-parallel test of stage 4a and the ``_near_axis`` sliver guard.
    Per-edge geometry is evaluated on a stacked (E, *batch) leading axis;
    the selection folds, which depend on the order of the edges, stay
    loops over the edges in that order.
    """
    nverts = len(edges)
    # every input broadcast to the common batch shape, so that the stacks
    # and the per-edge selects below see one shape
    parts = torch.broadcast_tensors(*plane.n, plane.d, *cap.a, *cap.d,
                                    cap.r, *v, *(c for p in verts for c in p))
    plane = Plane(n=Vec3(*parts[0:3]), d=parts[3])
    cap = Capsule(a=Vec3(*parts[4:7]), d=Vec3(*parts[7:10]), r=parts[10])
    v = Vec3(*parts[11:14])
    verts = tuple(Vec3(*parts[14 + 3 * k:17 + 3 * k])
                  for k in range(len(verts)))
    zero3 = vzeros_like(cap.a)
    like = cap.r

    # ---- stage 1: already piercing the plane inside the face -------------
    d_hat = safe_normalize(cap.d)
    denom_seg = dot(plane.n, cap.d)
    non_par = torch.abs(dot(plane.n, d_hat)) > COLLISION_EPSILON
    t_axis = safe_div(plane.d - dot(plane.n, cap.a), denom_seg)
    q_pierce = cap.a + cap.d * t_axis
    pierce = (non_par & (t_axis >= 0.0) & (t_axis <= 1.0)
              & contains_fn(q_pierce))
    deep_end = where_vec(dot(plane.n, cap.a) - plane.d < 0.0,
                         cap.a, cap.a + cap.d)
    c_pierce = Contact(a=q_pierce, b=deep_end - plane.n * cap.r, n=plane.n,
                       t=torch.zeros_like(like), valid=pierce)

    # ---- stage 2: endpoint-sphere seeds (collision.rs:723-764) -----------
    c1 = contact_plane_moving_sphere(plane, Sphere(c=cap.a, r=cap.r), v)
    c2 = contact_plane_moving_sphere(plane, Sphere(c=cap.a + cap.d, r=cap.r),
                                     v)
    cont1 = contains_fn(c1.a)
    cont2 = contains_fn(c2.a)

    both = c1.valid & c2.valid
    dbl = both & (c2.t == 0.0) & ~(c2.t < c1.t) & cont1 & cont2

    use2 = both & (c2.t < c1.t)
    t0 = both & ~(c2.t < c1.t) & (c2.t == 0.0)
    seed_valid = torch.where(both, ~t0 | cont1 | cont2,
                             c1.valid | c2.valid)
    pick2 = torch.where(both, use2 | (t0 & ~cont1 & cont2),
                        (~c1.valid) & c2.valid)
    seed = contact_select(pick2, c2, c1)
    seed_dir = where_vec(pick2, -cap.d, cap.d)
    checked = t0 & (cont1 | cont2)

    # silhouette setup (collision.rs:776-794)
    sil_v = seed_dir - plane.n * safe_div(dot(seed_dir, plane.n),
                                          magnitude2(plane.n))
    zero = torch.zeros_like(like)
    n_xy = Vec3(zero, zero, torch.ones_like(like))
    plane_rot = quat_from_arc(plane.n, n_xy)
    pn_d = plane.n * plane.d
    sa3 = qrotate(plane_rot, seed.a - pn_d)
    sb3 = qrotate(plane_rot, seed.a + sil_v - pn_d)
    sax, say = sa3.x, sa3.y
    sbx, sby = sb3.x, sb3.y

    stack1 = lambda xs: torch.stack(xs, dim=0)
    stackv = lambda vs: Vec3(stack1([p.x for p in vs]),
                             stack1([p.y for p in vs]),
                             stack1([p.z for p in vs]))
    bb = lambda g: g[None]                      # batch -> (1, *batch)
    bv = lambda p: Vec3(p.x[None], p.y[None], p.z[None])
    ea_s = stackv([verts[ia] for (ia, ib) in edges])   # (E, *batch)
    eb_s = stackv([verts[ib] for (ia, ib) in edges])
    nedges = len(edges)

    rotq = Quat(bb(plane_rot.w), bb(plane_rot.x), bb(plane_rot.y),
                bb(plane_rot.z))
    e2a = qrotate(rotq, ea_s - bv(pn_d))
    e2b = qrotate(rotq, eb_s - bv(pn_d))

    seed_par = torch.abs(dot(seed_dir, plane.n)) < COLLISION_EPSILON
    seed_on_face = seed_valid & (checked | contains_fn(seed.a))

    # stage 2a + 3: silhouette/edge 2-D intersections, batched over edges
    tt_e, hh_e = _seg_2d_intersect(bb(sax), bb(say), bb(sbx), bb(sby),
                                   e2a.x, e2a.y, e2b.x, e2b.y)

    # stage 2a: on-face seed second contact at t_max (collision.rs:797-840)
    t_max_a = torch.max(torch.where(hh_e, tt_e, 0.0), dim=0).values
    t_max_a = torch.where(t_max_a == 0.0, 1.0, t_max_a)
    q2a = seed.a + sil_v * t_max_a
    second_a = Contact(a=q2a, b=q2a, n=plane.n, t=seed.t,
                       valid=seed_on_face & seed_par)

    # stage 3: off-face parallel silhouette interval (collision.rs:841-889)
    found_b = torch.any(hh_e, dim=0)
    t_min_b = torch.min(torch.where(hh_e, tt_e, _INF), dim=0).values
    t_max_b = torch.max(torch.where(hh_e, tt_e, 0.0), dim=0).values
    t_max_b = torch.where(t_max_b == 0.0, 1.0, t_max_b)
    stage3 = seed_valid & ~seed_on_face & (seed.t > 0.0) & seed_par & found_b
    q3a = seed.a + sil_v * t_min_b
    q3b = seed.a + sil_v * t_max_b

    # ---- stage 4: Minkowski-sum sweep fallback (collision.rs:891-1084) ---
    cd_mag2 = magnitude2(cap.d)
    cd_mag = magnitude(cap.d)

    # 4a. parallel edges (collision.rs:901-971), geometry batched over edges
    ab_s = eb_s - ea_s
    ab_cd_s = dot(ab_s, bv(cap.d))
    # relative-tolerance edge-parallel test (the reference tests exact f32
    # equality, collision.rs:907, and a nearly parallel edge then falls into
    # the quad path whose sliver triangles have garbage normals)
    is_par_e = torch.abs(ab_cd_s) >= bb(cd_mag) * magnitude(ab_s) * (1.0
                                                                     - 1e-6)
    par_vert = [torch.zeros_like(like, dtype=torch.bool)
                for _ in range(nverts)]
    for e, (ia, ib) in enumerate(edges):
        par_vert[ia] = par_vert[ia] | is_par_e[e]
        par_vert[ib] = par_vert[ib] | is_par_e[e]
    flip = ab_cd_s < 0.0
    e0 = where_vec(flip, eb_s, ea_s)
    e1 = where_vec(flip, ea_s, eb_s)
    m_edge = magnitude2(ab_s)

    i1 = intersect_capsule(bv(cap.a), bv(v), _INF,
                           Capsule(a=e0, d=e1 - e0, r=bb(cap.r)))
    tri_p1 = closest_pt_segment(Segment(a=e0, b=e1), i1.p)
    m_proj1 = magnitude2((tri_p1 + bv(cap.d)) - e0)
    c_t = torch.where(m_proj1 > m_edge,
                      safe_div(m_proj1 - m_edge,
                               m_proj1 - magnitude2(tri_p1 - e0)),
                      1.0)
    q1 = tri_p1 + bv(cap.d) * c_t

    i2 = intersect_capsule(bv(cap.a), bv(v), _INF,
                           Capsule(a=e0, d=-bv(cap.d), r=bb(cap.r)))
    cap_t2 = safe_div(-dot(i2.p - e0, bv(cap.d)), bb(cd_mag2))
    tri_p2 = closest_pt_segment(Segment(a=e0, b=e0 - bv(cap.d)), i2.p)
    a2_pt = tri_p2 + bv(cap.d) * cap_t2
    m_proj2 = magnitude2((tri_p2 + bv(cap.d)) - e0)
    b2_pt = where_vec(m_proj2 > m_edge, e1, tri_p2 + bv(cap.d))

    # per-edge candidate: i1 when it hit, else i2 (the reference considers
    # i2 only on ~i1.hit, collision.rs:933); the fold keeps the sequential
    # last-wins-on-tie update order
    cand_v = is_par_e & (i1.hit | (~i1.hit & i2.hit))
    cand_t = torch.where(i1.hit, i1.t, i2.t)
    cand_a = where_vec(i1.hit, tri_p1, a2_pt)
    cand_b = where_vec(i1.hit, q1, b2_pt)

    best_par_t = torch.full_like(like, _INF)
    best_par_a = zero3
    best_par_b = zero3
    sel_e = lambda t, e: tree_map(lambda g: g[e], t)
    for e in range(nedges):
        upd = cand_v[e] & ~(cand_t[e] > torch.clamp(best_par_t, max=1.0))
        best_par_a = where_vec(upd, sel_e(cand_a, e), best_par_a)
        best_par_b = where_vec(upd, sel_e(cand_b, e), best_par_b)
        best_par_t = torch.where(upd, cand_t[e], best_par_t)

    # 4b. non-parallel edge quads + vertex capsules (collision.rs:972-1060),
    # geometry batched over edges; the ordered candidate fold stays exact
    a_par_e = stack1([par_vert[ia] for (ia, ib) in edges])
    b_par_e = stack1([par_vert[ib] for (ia, ib) in edges])

    tri0 = Triangle(a=ea_s - bv(cap.d), b=ea_s, c=eb_s)
    tri1 = Triangle(a=ea_s - bv(cap.d), b=eb_s, c=eb_s - bv(cap.d))
    p2 = plane_from_triangle(tri1)
    pcs = contact_plane_moving_sphere(p2, Sphere(c=bv(cap.a), r=bb(cap.r)),
                                      bv(v))
    # a sliver quad (edge nearly parallel to the axis but below the is_par
    # tolerance) has a noise normal: skip its face test and fall through to
    # the robust edge/vertex capsule raycasts
    quad_ok = (magnitude2(cross(bv(cap.d), ab_s))
               > 1e-10 * bb(cd_mag2) * magnitude2(ab_s))
    gate_e = pcs.valid & ~(a_par_e & b_par_e) & quad_ok
    on_quad_cont = (contains_triangle_pt(tri0, pcs.a)
                    | contains_triangle_pt(tri1, pcs.b))
    cap_t4 = safe_div(-dot(pcs.a - ea_s, bv(cap.d)), bb(cd_mag2))
    q_quad = pcs.a + bv(cap.d) * cap_t4

    ib_ = intersect_capsule(bv(cap.a), bv(v), _INF,
                            Capsule(a=ea_s, d=ab_s, r=bb(cap.r)))
    qb = closest_pt_segment(Segment(a=ea_s, b=eb_s), ib_.p)
    it_ = intersect_capsule(bv(cap.a), bv(v), _INF,
                            Capsule(a=ea_s - bv(cap.d), d=ab_s,
                                    r=bb(cap.r)))
    qt = closest_pt_segment(Segment(a=ea_s, b=eb_s), it_.p + bv(cap.d))
    iva = intersect_capsule(bv(cap.a), bv(v), _INF,
                            Capsule(a=ea_s, d=-bv(cap.d), r=bb(cap.r)))
    ivb = intersect_capsule(bv(cap.a), bv(v), _INF,
                            Capsule(a=eb_s, d=-bv(cap.d), r=bb(cap.r)))

    best_sum_t = torch.full_like(like, _INF)
    best_sum_p = zero3
    for e in range(nedges):
        gate = gate_e[e]
        on_quad = gate & (best_sum_t > pcs.t[e]) & on_quad_cont[e]
        best_sum_p = where_vec(on_quad, sel_e(q_quad, e), best_sum_p)
        best_sum_t = torch.where(on_quad, pcs.t[e], best_sum_t)

        sub_gate = gate & ~on_quad
        ok = sub_gate & ib_.hit[e] & (ib_.t[e] <= 1.0) \
            & (ib_.t[e] <= best_sum_t)
        best_sum_p = where_vec(ok, sel_e(qb, e), best_sum_p)
        best_sum_t = torch.where(ok, ib_.t[e], best_sum_t)

        ok = sub_gate & it_.hit[e] & (it_.t[e] <= 1.0) \
            & (it_.t[e] <= best_sum_t)
        best_sum_p = where_vec(ok, sel_e(qt, e), best_sum_p)
        best_sum_t = torch.where(ok, it_.t[e], best_sum_t)

        for iv, vert_e, vpar in ((iva, ea_s, a_par_e), (ivb, eb_s, b_par_e)):
            ok = (sub_gate & ~vpar[e] & iv.hit[e] & (iv.t[e] <= 1.0)
                  & (iv.t[e] <= best_sum_t))
            best_sum_p = where_vec(ok, sel_e(vert_e, e), best_sum_p)
            best_sum_t = torch.where(ok, iv.t[e], best_sum_t)

    sum_wins = best_sum_t < best_par_t
    par_found = best_par_t < _INF
    c4_first = contact_select(
        sum_wins,
        Contact(a=best_sum_p, b=best_sum_p, n=plane.n, t=best_sum_t,
                valid=best_sum_t < _INF),
        Contact(a=best_par_a, b=best_par_a, n=plane.n, t=best_par_t,
                valid=par_found))
    c4_second = Contact(a=best_par_b, b=best_par_b, n=plane.n, t=best_par_t,
                        valid=par_found & ~sum_wins)

    def _near_axis(c: Contact):
        """Sliver guard of the JAX package: sliver Minkowski triangles have
        catastrophic containment denominators in f32 and can admit
        projections far from the capsule.  Every legitimate stage-4 contact
        point lies on the triangle within the capsule's surface reach of its
        axis at the TOI, so filter by that property."""
        shift = v * c.t
        at = closest_pt_segment(
            Segment(a=cap.a + shift, b=cap.a + shift + cap.d), c.a)
        return magnitude2(c.a - at) <= (cap.r * 1.05 + 0.02) ** 2

    c4_first = c4_first._replace(valid=c4_first.valid
                                 & _near_axis(c4_first))
    c4_second = c4_second._replace(valid=c4_second.valid
                                   & _near_axis(c4_second))

    # ---- final priority selection into 2 slots ---------------------------
    miss = contact_miss(cap.a)
    slot0 = c4_first
    slot1 = c4_second
    c3a = Contact(a=q3a, b=q3a, n=plane.n, t=seed.t, valid=stage3)
    c3b = Contact(a=q3b, b=q3b, n=plane.n, t=seed.t, valid=stage3)
    slot0 = contact_select(stage3, c3a, slot0)
    slot1 = contact_select(stage3, c3b, slot1)
    slot0 = contact_select(seed_on_face, seed._replace(valid=seed_on_face),
                           slot0)
    slot1 = contact_select(seed_on_face, second_a, slot1)
    # double resting contact emits c2 then c1 (collision.rs:742-745)
    slot0 = contact_select(dbl, c2._replace(valid=dbl), slot0)
    slot1 = contact_select(dbl, c1._replace(valid=dbl), slot1)
    slot0 = contact_select(pierce, c_pierce, slot0)
    slot1 = contact_select(pierce, miss, slot1)

    return contact_stack([slot0, slot1])


def contact_triangle_moving_capsule(tri: Triangle, cap: Capsule,
                                    v: Vec3) -> Contact:
    """Triangle x Moving<Capsule> (collision.rs:693-1086). 2 contact slots."""
    return _contact_polygon_moving_capsule(
        plane_from_triangle(tri), triangle_vertices(tri), TRIANGLE_EDGES,
        lambda p: contains_triangle_pt(tri, p), cap, v)


def contact_rectangle_moving_capsule(rect: Rectangle, cap: Capsule,
                                     v: Vec3) -> Contact:
    """Rectangle x Moving<Capsule>. 2 contact slots."""
    return _contact_polygon_moving_capsule(
        plane_from_rectangle(rect), rectangle_vertices(rect),
        RECTANGLE_EDGES, lambda p: contains_rectangle_pt(rect, p), cap, v)


def contact_moving_moving(contact_fn: Callable, shape_a, v_a: Vec3, shape_b,
                          v_b: Vec3) -> Contact:
    """Reduce two moving shapes to one static + relative velocity
    (collision.rs:1387-1401): ``contact_fn(a, b, v_b - v_a)`` advected by
    ``v_a * t``."""
    c = contact_fn(shape_a, shape_b, v_b - v_a)
    return contact_advect(c, v_a * c.t)


def contact_moving_static(contact_fn: Callable, shape_a, v_a: Vec3,
                          shape_b) -> Contact:
    """Moving receiver vs static argument (collision.rs:1368-1382)."""
    c = contact_fn(shape_a, shape_b, -v_a)
    return contact_advect(c, v_a * c.t)


def local_contact(c: Contact, center_a: Vec3, v_a: Vec3, center_b: Vec3,
                  v_b: Vec3) -> LocalContact:
    """Per-body local contact points at the TOI (collision.rs:1508-1532):
    local = global - (center + v * t)."""
    return LocalContact(local_a=c.a - (center_a + v_a * c.t),
                        local_b=c.b - (center_b + v_b * c.t),
                        contact=c)

"""Continuous narrowphase of the sphere slice, branch-free on tensors.

Counterpart of the sphere part of ``mgf_tpu.collision`` (reference:
collision.rs).  Every routine returns fixed-shape results with validity
masks and is batched over any tensor shape.  Masked-out lanes never produce
NaNs that could leak through selects.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from mgf_tpu_torch.geom import (
    Capsule, Plane, Segment, Sphere, Triangle, TRIANGLE_EDGES,
    closest_pt_segment, plane_from_triangle, triangle_vertices,
)
from mgf_tpu_torch.math3d import (
    COLLISION_EPSILON, Vec3, dot, magnitude2, safe_div, safe_normalize,
    safe_sqrt, tree_map, vzeros_like, where_vec,
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


def intersect_plane(pos: Vec3, d: Vec3, dt, plane: Plane) -> Intersection:
    """collision.rs:169-184."""
    denom = dot(plane.n, d)
    t = safe_div(plane.d - dot(plane.n, pos), denom)
    hit = (denom != 0.0) & (t > 0.0) & (t <= dt)
    return Intersection(p=pos + d * t, t=t, hit=hit)


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


def intersect_capsule(pos: Vec3, d: Vec3, dt, cap: Capsule) -> Intersection:
    """Ray/segment vs capsule (collision.rs:275-359): infinite-cylinder
    quadratic clamped to the endcap spheres; the axis-parallel case
    degenerates to a sphere test at the nearest endcap."""
    m = pos - cap.a
    md = dot(m, cap.d)
    nd = dot(d, cap.d)
    dd = magnitude2(cap.d)
    nn = magnitude2(d)
    mn = dot(m, d)
    a = dd * nn - nd * nd
    k = magnitude2(m) - cap.r * cap.r

    def sphere_quad(b, c):
        discr = b * b - nn * c
        t = torch.clamp(safe_div(-b - safe_sqrt(discr), nn), min=0.0)
        ok = (~((c > 0.0) & (b > 0.0))) & (discr >= 0.0) & (nn > 0.0)
        return t, ok

    # parallel path (collision.rs:288-313)
    m2 = pos - (cap.a + cap.d)
    k2 = magnitude2(m2) - cap.r * cap.r
    b_m2 = dot(m2, d)
    par_b = torch.where(md < 0.0, mn, b_m2)
    par_c = torch.where(md < 0.0, k, k2)
    par_inside = (md >= 0.0) & (md <= dd)
    par_t, par_ok = sphere_quad(par_b, par_c)
    par_ok = par_ok & ~par_inside & (par_t <= dt)

    # general path (collision.rs:314-357)
    c_cyl = dd * k - md * md
    b_cyl = dd * mn - nd * md
    discr = b_cyl * b_cyl - a * c_cyl
    t_cyl = safe_div(-b_cyl - safe_sqrt(discr), a)
    gen_ok = (discr >= 0.0) & (t_cyl >= 0.0)

    axial = md + t_cyl * nd
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
    return Intersection(p=pos + d * t, t=t, hit=hit)


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


def contact_triangle_moving_sphere(tri: Triangle, s: Sphere,
                                   v: Vec3) -> Contact:
    """Triangle vs swept sphere: face first, then the earliest edge hit
    (collision.rs:610-659, the polygon routine on a triangle)."""
    plane = plane_from_triangle(tri)
    pc = contact_plane_moving_sphere(plane, s, v)
    on_face = pc.valid & contains_triangle_pt(tri, pc.a)

    verts = triangle_vertices(tri)
    moving = magnitude2(v) != 0.0
    first_t = torch.full_like(pc.t, _INF)
    tri_p = vzeros_like(s.c)
    for (ia, ib) in TRIANGLE_EDGES:
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


def contact_moving_moving(contact_fn: Callable, shape_a, v_a: Vec3, shape_b,
                          v_b: Vec3) -> Contact:
    """Reduce two moving shapes to one static + relative velocity
    (collision.rs:1387-1401): ``contact_fn(a, b, v_b - v_a)`` advected by
    ``v_a * t``."""
    c = contact_fn(shape_a, shape_b, v_b - v_a)
    return contact_advect(c, v_a * c.t)

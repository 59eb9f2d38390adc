"""Bounding-volume algebra: AABB and bounding-sphere operations
(counterpart of ``mgf_tpu.bounds``; reference: bounds.rs).

Combine, surface area, expand and scale on AABBs and spheres, the bounds
of a moving shape, and the AABB and sphere bounds of every shape type.
"""

from __future__ import annotations

import torch

from mgf_tpu_torch.geom import (
    AABB, OBB, Capsule, Rectangle, Sphere, Triangle, rotate_aabb,
)
from mgf_tpu_torch.math3d import (
    COLLISION_EPSILON, Vec3, magnitude, magnitude2, safe_div, vabs, vmax,
    vmin, vsplat, where_vec,
)


# AABB as a Bound (bounds.rs:109-135) ---------------------------------------

def aabb_combine(a: AABB, b: AABB) -> AABB:
    """Smallest AABB enclosing both (bounds.rs:113-130)."""
    lower = vmin(a.c - a.r, b.c - b.r)
    upper = vmax(a.c + a.r, b.c + b.r)
    return AABB(c=(upper + lower) * 0.5, r=(upper - lower) * 0.5)


def aabb_surface_area(a: AABB):
    """bounds.rs:132-134.  The reference's quirk: half-extent products
    without the x8 factor (1/8 the true area); only used for SAH ratios."""
    return a.r.x * a.r.y + a.r.y * a.r.z + a.r.z * a.r.x


def aabb_expand(a: AABB, s) -> AABB:
    """Scalar extend (bounds.rs:95-97)."""
    s = torch.as_tensor(s, dtype=torch.float32, device=a.r.x.device)
    return AABB(c=a.c, r=a.r + vsplat(s.expand(a.r.x.shape)))


def aabb_scale(a: AABB, s) -> AABB:
    """Scalar multiply (bounds.rs:77-79)."""
    return AABB(c=a.c, r=a.r * s)


def swept_aabb(a: AABB, v: Vec3) -> AABB:
    """Bounds of a Moving shape: combine(start, start + v)
    (bounds.rs:60-68)."""
    return aabb_combine(a, AABB(c=a.c + v, r=a.r))


# Sphere as a Bound (bounds.rs:235-262) -------------------------------------

def sphere_combine(a: Sphere, b: Sphere) -> Sphere:
    """Smallest sphere enclosing both (bounds.rs:236-257)."""
    d = b.c - a.c
    rdiff = b.r - a.r
    contained = rdiff * rdiff >= magnitude2(d)
    bigger_c = where_vec(a.r >= b.r, a.c, b.c)
    bigger_r = torch.maximum(a.r, b.r)
    dist = magnitude(d)
    r = (dist + a.r + b.r) * 0.5
    shift = torch.where(dist > COLLISION_EPSILON, safe_div(r - a.r, dist),
                        0.0)
    c = a.c + d * shift
    return Sphere(c=where_vec(contained, bigger_c, c),
                  r=torch.where(contained, bigger_r, r))


def sphere_surface_area(s: Sphere):
    """bounds.rs:259-261 (r^2; SAH-ratio use only)."""
    return s.r * s.r


def swept_sphere(s: Sphere, v: Vec3) -> Sphere:
    return sphere_combine(s, Sphere(c=s.c + v, r=s.r))


# BoundedBy<AABB> (bounds.rs:137-197) ---------------------------------------

def triangle_aabb(t: Triangle) -> AABB:
    """bounds.rs:138-153: centered on the *centroid* with max-abs
    extents."""
    c = (t.a + t.b + t.c) * (1.0 / 3.0)
    r = vmax(vabs(t.a - c), vmax(vabs(t.b - c), vabs(t.c - c)))
    return AABB(c=c, r=r)


def rectangle_aabb(rect: Rectangle) -> AABB:
    """bounds.rs:156-168."""
    p1 = rect.u0 * rect.e0
    p2 = rect.u1 * rect.e1
    return AABB(c=rect.c, r=vmax(vabs(p1), vabs(p2)))


def sphere_aabb(s: Sphere) -> AABB:
    """bounds.rs:170-177."""
    return AABB(c=s.c, r=vsplat(s.r))


def capsule_aabb(c: Capsule) -> AABB:
    """bounds.rs:179-188: conservative cube covering all rotations."""
    r = c.r + magnitude(c.d) * 0.5
    return AABB(c=c.a + c.d * 0.5, r=vsplat(r))


def obb_aabb(o: OBB) -> AABB:
    """bounds.rs:190-197."""
    return rotate_aabb(AABB(c=o.c, r=o.r), o.q)


# BoundedBy<Sphere> (bounds.rs:264-319) -------------------------------------

def triangle_sphere(t: Triangle) -> Sphere:
    """bounds.rs:264-276."""
    c = (t.a + t.b + t.c) * (1.0 / 3.0)
    r2 = torch.maximum(magnitude2(t.a - c),
                       torch.maximum(magnitude2(t.b - c),
                                     magnitude2(t.c - c)))
    return Sphere(c=c, r=torch.sqrt(r2))


def rectangle_sphere(rect: Rectangle) -> Sphere:
    """bounds.rs:278-285 (the reference's sqrt(e0 + e1), kept)."""
    return Sphere(c=rect.c, r=torch.sqrt(rect.e0 + rect.e1))


def aabb_sphere(a: AABB) -> Sphere:
    """bounds.rs:291-298."""
    return Sphere(c=a.c, r=magnitude(a.r))


def capsule_sphere(c: Capsule) -> Sphere:
    """bounds.rs:300-309."""
    return Sphere(c=c.a + c.d * 0.5, r=c.r + magnitude(c.d) * 0.5)


def obb_sphere(o: OBB) -> Sphere:
    """bounds.rs:311-319 (max half-extent, the reference's quirk kept)."""
    return Sphere(c=o.c, r=torch.maximum(o.r.x, torch.maximum(o.r.y,
                                                              o.r.z)))

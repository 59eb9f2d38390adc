"""Primitive shapes, as NamedTuples of tensors.

Counterpart of the sphere, capsule, segment, plane, triangle, rectangle and
AABB part of ``mgf_tpu.geom`` (reference: geom.rs).  A single shape and a batch of a
million are the same type; every routine is branch-free.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mgf_tpu_torch.math3d import (
    COLLISION_EPSILON, Vec3, clamp, cross, dot, magnitude2, normalize,
    safe_div, safe_normalize, where_vec,
)


class Plane(NamedTuple):
    """A unit normal and a distance from the origin (geom.rs:32-37)."""
    n: Vec3
    d: torch.Tensor


class Segment(NamedTuple):
    """Two endpoints (geom.rs:91-96)."""
    a: Vec3
    b: Vec3


class Triangle(NamedTuple):
    """Three points in space (geom.rs:128-136)."""
    a: Vec3
    b: Vec3
    c: Vec3


class Rectangle(NamedTuple):
    """Center, two unit axes, two half-widths (geom.rs:216-223)."""
    c: Vec3
    u0: Vec3
    u1: Vec3
    e0: torch.Tensor
    e1: torch.Tensor


class AABB(NamedTuple):
    """Axis-aligned box: center + half widths (geom.rs:257-260)."""
    c: Vec3
    r: Vec3


class Sphere(NamedTuple):
    """A point and a radius (geom.rs:290-295)."""
    c: Vec3
    r: torch.Tensor


class Capsule(NamedTuple):
    """A sphere swept along a segment: start, axis, radius (geom.rs:316-323):
    a capsule body's collider, and the swept volume of a moving sphere."""
    a: Vec3
    d: Vec3
    r: torch.Tensor


def plane_from_triangle(t: Triangle) -> Plane:
    """Plane through the triangle's points (geom.rs:49-58)."""
    n = normalize(cross(t.b - t.a, t.c - t.a))
    return Plane(n=n, d=dot(n, t.a))


def triangle_vertices(t: Triangle):
    """Vertex tuple in (a, b, c) order."""
    return (t.a, t.b, t.c)


def plane_from_rectangle(r: Rectangle) -> Plane:
    """geom.rs:240-246 (n = u1 x u0)."""
    n = cross(r.u1, r.u0)
    return Plane(n=n, d=dot(n, r.c))


def rectangle(c: Vec3, u0: Vec3, u1: Vec3, e0, e1) -> Rectangle:
    return Rectangle(c=c, u0=u0, u1=u1,
                     e0=torch.as_tensor(e0, dtype=torch.float32),
                     e1=torch.as_tensor(e1, dtype=torch.float32))


def rectangle_vertices(r: Rectangle):
    """Corner tuple, geom.rs:906-917 ordering."""
    u0e = r.u0 * r.e0
    u1e = r.u1 * r.e1
    return (r.c + u0e + u1e, r.c + u0e - u1e, r.c - u0e - u1e,
            r.c - u0e + u1e)


TRIANGLE_EDGES = ((0, 1), (1, 2), (2, 0))  # geom.rs:899
RECTANGLE_EDGES = ((0, 1), (1, 2), (2, 3), (3, 0))  # geom.rs:921


def segment_of_capsule(c: Capsule) -> Segment:
    return Segment(a=c.a, b=c.a + c.d)


def capsule_center(c: Capsule) -> Vec3:
    return c.a + c.d * 0.5


def closest_pt_segment(s: Segment, to: Vec3) -> Vec3:
    """geom.rs:590-603."""
    ab = s.b - s.a
    t = dot(ab, to - s.a)
    frac = clamp(safe_div(t, magnitude2(ab)), 0.0, 1.0)
    return s.a + ab * frac


def closest_pt_sphere(s: Sphere, to: Vec3) -> Vec3:
    """geom.rs:751-755.  The reference returns ``c + d (|d|^2/r^2)``, not a
    surface projection unless |d| == r; kept verbatim, the capsule's
    closest point composes through it (geom.rs:791-795)."""
    d = to - s.c
    return s.c + d * safe_div(magnitude2(d), s.r * s.r)


def closest_pt_capsule(c: Capsule, to: Vec3) -> Vec3:
    """geom.rs:791-795 (segment closest point -> sphere quirk)."""
    seg_pt = closest_pt_segment(segment_of_capsule(c), to)
    return closest_pt_sphere(Sphere(c=seg_pt, r=c.r), to)


def closest_pts_seg(seg1: Segment, seg2: Segment):
    """Closest points between two segments (geom.rs:408-444, Ericson 5.1.9).

    Returns ``(p1, p2, parallel)``; the reference returns ``None`` exactly
    when the segments are parallel with interior overlap (geom.rs:428-431),
    reported here by the ``parallel`` flag; callers pick their fallback.

    The parallel test is the JAX package's RELATIVE one, op for op:
    denom = a e sin^2(angle) cancels catastrophically for near-parallel
    segments, so with the exact ``denom == 0`` test the float precision
    picks the branch and the non-parallel s is ill-conditioned there.
    sin^2 <= 1e-6 classifies as parallel (PARITY.md)."""
    d1 = seg1.b - seg1.a
    d2 = seg2.b - seg2.a
    a = magnitude2(d1)
    e = magnitude2(d2)
    r = seg1.a - seg2.a
    f = dot(d2, r)
    c = dot(d1, r)
    b = dot(d1, d2)
    denom = a * e - b * b

    both_pts = a <= COLLISION_EPSILON
    seg2_pt = e <= COLLISION_EPSILON

    parallel = (denom <= COLLISION_EPSILON * a * e) & ~both_pts & ~seg2_pt
    s_gen = clamp(safe_div(b * f - c * e, denom), 0.0, 1.0)
    t_unnorm = b * s_gen + f
    s_gen = torch.where(t_unnorm < 0.0, clamp(safe_div(-c, a), 0.0, 1.0),
                        s_gen)
    s_gen = torch.where(t_unnorm > e, clamp(safe_div(b - c, a), 0.0, 1.0),
                        s_gen)
    t_gen = torch.where(t_unnorm < 0.0, 0.0,
                        torch.where(t_unnorm > e, 1.0,
                                    safe_div(t_unnorm, e)))

    s = torch.where(both_pts, 0.5,
                    torch.where(seg2_pt, clamp(safe_div(-c, a), 0.0, 1.0),
                                s_gen))
    t = torch.where(both_pts,
                    torch.where(e <= COLLISION_EPSILON, 0.5,
                                clamp(safe_div(f, e), 0.0, 1.0)),
                    torch.where(seg2_pt, 0.0, t_gen))

    return seg1.a + d1 * s, seg2.a + d2 * t, parallel


def compute_basis(n: Vec3):
    """Orthonormal tangent basis for a unit normal (geom.rs:1138-1145,
    from Box2D).  Returns (t1, t2)."""
    zero = torch.zeros_like(n.x)
    use_x = torch.abs(n.x) >= 0.57735
    b = where_vec(use_x, Vec3(n.y, -n.x, zero), Vec3(zero, n.z, -n.y))
    b = safe_normalize(b)
    return b, cross(n, b)

"""Primitive shapes the sphere slice needs, as NamedTuples of tensors.

Counterpart of the sphere, segment, plane, triangle and AABB part of
``mgf_tpu.geom`` (reference: geom.rs).  A single shape and a batch of a
million are the same type; every routine is branch-free.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mgf_tpu_torch.math3d import (
    Vec3, cross, dot, magnitude2, normalize, safe_div, safe_normalize,
    where_vec,
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


class AABB(NamedTuple):
    """Axis-aligned box: center + half widths (geom.rs:257-260)."""
    c: Vec3
    r: Vec3


class Sphere(NamedTuple):
    """A point and a radius (geom.rs:290-295)."""
    c: Vec3
    r: torch.Tensor


class Capsule(NamedTuple):
    """A sphere swept along a segment: start, axis, radius (geom.rs:316-323).
    The slice uses it only as the swept volume of a moving sphere."""
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


TRIANGLE_EDGES = ((0, 1), (1, 2), (2, 0))  # geom.rs:899


def closest_pt_segment(s: Segment, to: Vec3) -> Vec3:
    """geom.rs:590-603."""
    ab = s.b - s.a
    t = dot(ab, to - s.a)
    frac = torch.clamp(safe_div(t, magnitude2(ab)), 0.0, 1.0)
    return s.a + ab * frac


def compute_basis(n: Vec3):
    """Orthonormal tangent basis for a unit normal (geom.rs:1138-1145,
    from Box2D).  Returns (t1, t2)."""
    zero = torch.zeros_like(n.x)
    use_x = torch.abs(n.x) >= 0.57735
    b = where_vec(use_x, Vec3(n.y, -n.x, zero), Vec3(zero, n.z, -n.y))
    b = safe_normalize(b)
    return b, cross(n, b)

"""Primitive shapes, as NamedTuples of tensors.

Counterpart of ``mgf_tpu.geom`` (reference: geom.rs): the shape types,
their constructors, centers, closest points, rotations and the support
functions GJK reads.  A single shape and a batch of a million are the same
type; every routine is branch-free.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mgf_tpu_torch.math3d import (
    COLLISION_EPSILON, Mat3, Quat, Vec3, clamp, cross, dot, magnitude,
    magnitude2, mat_vec, normalize, qconj, qmul, qrotate, quat_to_mat,
    safe_div, safe_normalize, vclamp, vmul, where_vec,
)


class Plane(NamedTuple):
    """A unit normal and a distance from the origin (geom.rs:32-37)."""
    n: Vec3
    d: torch.Tensor


class Ray(NamedTuple):
    """A point and a direction with infinite extent (geom.rs:63-68)."""
    p: Vec3
    d: Vec3


class Segment(NamedTuple):
    """Two endpoints (geom.rs:91-96)."""
    a: Vec3
    b: Vec3


class Triangle(NamedTuple):
    """Three points in space (geom.rs:128-136)."""
    a: Vec3
    b: Vec3
    c: Vec3


class Tetrahedron(NamedTuple):
    """Four points in space (geom.rs:195-200)."""
    a: Vec3
    b: Vec3
    c: Vec3
    d: Vec3


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


class OBB(NamedTuple):
    """Oriented box: center + rotation + half widths (geom.rs:272-276)."""
    c: Vec3
    q: Quat
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


class Moving(NamedTuple):
    """A geometry swept across a path of motion (geom.rs:357)."""
    shape: tuple
    v: Vec3


def moving(shape, v):
    return Moving(shape, v)


def plane_from_points(a: Vec3, b: Vec3, c: Vec3) -> Plane:
    """Plane through three points (geom.rs:49-58)."""
    n = normalize(cross(b - a, c - a))
    return Plane(n=n, d=dot(n, a))


def plane_from_triangle(t: Triangle) -> Plane:
    return plane_from_points(t.a, t.b, t.c)


def capsule_from_moving_sphere(s: Sphere, v: Vec3) -> Capsule:
    """geom.rs:344-352."""
    return Capsule(a=s.c, d=v, r=s.r)


def ray_clamp(r: Ray, t) -> Segment:
    """geom.rs:80-86."""
    return Segment(a=r.p, b=r.p + r.d * t)


def triangle_normal(t: Triangle) -> Vec3:
    """geom.rs:149-151 (unit length, not cached)."""
    return normalize(cross(t.b - t.a, t.c - t.a))


def triangle_barycentric(t: Triangle, p: Vec3):
    """Barycentric coordinates (v, w, 1-v-w) of p (geom.rs:154-167)."""
    v0 = t.b - t.a
    v1 = t.c - t.a
    v2 = p - t.a
    d0 = dot(v0, v0)
    d1 = dot(v0, v1)
    d2 = dot(v1, v1)
    d3 = dot(v2, v0)
    d4 = dot(v2, v1)
    denom = d0 * d2 - d1 * d1
    v = safe_div(d2 * d3 - d1 * d4, denom)
    w = safe_div(d0 * d4 - d1 * d3, denom)
    return v, w, 1.0 - v - w


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


# centers and positions (Shape::center / set_pos, geom.rs:456) -------------

def plane_center(p: Plane) -> Vec3:
    return p.n * p.d


def segment_center(s: Segment) -> Vec3:
    return (s.a + s.b) * 0.5


def triangle_center(t: Triangle) -> Vec3:
    return (t.a + t.b + t.c) * (1.0 / 3.0)


def capsule_center(c: Capsule) -> Vec3:
    return c.a + c.d * 0.5


def sphere_set_pos(s: Sphere, p: Vec3) -> Sphere:
    return Sphere(c=p, r=s.r)


def capsule_set_pos(c: Capsule, p: Vec3) -> Capsule:
    disp = p - capsule_center(c)
    return Capsule(a=c.a + disp, d=c.d, r=c.r)


def _aabb_set_pos(b: AABB, p: Vec3) -> AABB:
    return b._replace(c=p)


def _obb_set_pos(b: OBB, p: Vec3) -> OBB:
    return b._replace(c=p)


# closest points (Shape::closest_point, geom.rs:465) ------------------------

def closest_pt_plane(p: Plane, to: Vec3) -> Vec3:
    """geom.rs:533-535."""
    return to - p.n * (dot(p.n, to) - p.d)


def closest_pt_ray(r: Ray, to: Vec3) -> Vec3:
    """geom.rs:545-552."""
    t = dot(to - r.p, r.d)
    s = safe_div(t, magnitude2(r.d))
    return where_vec(t < 0.0, r.p, r.p + r.d * s)


def closest_pt_segment(s: Segment, to: Vec3) -> Vec3:
    """geom.rs:590-603."""
    ab = s.b - s.a
    t = dot(ab, to - s.a)
    frac = clamp(safe_div(t, magnitude2(ab)), 0.0, 1.0)
    return s.a + ab * frac


def closest_pt_triangle(t: Triangle, to: Vec3) -> Vec3:
    """Ericson-style 7-region test, branch-free (geom.rs:643-688)."""
    ab = t.b - t.a
    ac = t.c - t.a
    ap = to - t.a
    d1 = dot(ab, ap)
    d2 = dot(ac, ap)

    bp = to - t.b
    d3 = dot(ab, bp)
    d4 = dot(ac, bp)

    cp = to - t.c
    d5 = dot(ab, cp)
    d6 = dot(ac, cp)

    vc = d1 * d4 - d3 * d2
    vb = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4

    p_ab = t.a + ab * safe_div(d1, d1 - d3)
    p_ac = t.a + ac * safe_div(d2, d2 - d6)
    p_bc = t.b + (t.c - t.b) * safe_div(d4 - d3, (d4 - d3) + (d5 - d6))
    denom = va + vb + vc
    p_face = t.a + ab * safe_div(vb, denom) + ac * safe_div(vc, denom)

    c_a = (d1 <= 0.0) & (d2 <= 0.0)
    c_b = (d3 >= 0.0) & (d4 <= d3)
    c_ab = (vc <= 0.0) & (d1 >= 0.0) & (d3 <= 0.0)
    c_c = (d6 >= 0.0) & (d5 <= d6)
    c_ac = (vb <= 0.0) & (d2 >= 0.0) & (d6 <= 0.0)
    c_bc = (va <= 0.0) & ((d4 - d3) >= 0.0) & ((d5 - d6) >= 0.0)

    out = p_face
    out = where_vec(c_bc, p_bc, out)
    out = where_vec(c_ac, p_ac, out)
    out = where_vec(c_c, t.c, out)
    out = where_vec(c_ab, p_ab, out)
    out = where_vec(c_b, t.b, out)
    out = where_vec(c_a, t.a, out)
    return out


def closest_pt_rectangle(r: Rectangle, to: Vec3) -> Vec3:
    """geom.rs:698-707."""
    d = to - r.c
    q = r.c
    q = q + r.u0 * torch.clamp(dot(d, r.u0), -r.e0, r.e0)
    q = q + r.u1 * torch.clamp(dot(d, r.u1), -r.e1, r.e1)
    return q


def closest_pt_aabb(box: AABB, to: Vec3) -> Vec3:
    """geom.rs:716-722."""
    return vclamp(to, box.c - box.r, box.c + box.r)


def closest_pt_obb(box: OBB, to: Vec3) -> Vec3:
    """geom.rs:732-741.  Keeps the reference quirk: the rotated query is
    clamped against the box's *unrotated* center extent and rotated back
    without recentering."""
    local = qrotate(qconj(box.q), to)
    clamped = vclamp(local, box.c - box.r, box.c + box.r)
    return qrotate(box.q, clamped)


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


# rotation (Volumetric, geom.rs:928-1014) ----------------------------------

def rotate_aabb(box: AABB, q: Quat) -> AABB:
    """The AABB of the rotated box (geom.rs:941-985): new half-extents =
    |R| @ r, equivalent to the reference's 8-corner min/max."""
    am = Mat3(*(torch.abs(c) for c in quat_to_mat(q)))
    return AABB(c=box.c, r=mat_vec(am, box.r))


def rotate_obb(box: OBB, q: Quat) -> OBB:
    """geom.rs:989-996."""
    return OBB(c=box.c, q=qmul(q, box.q), r=box.r)


def rotate_sphere(s: Sphere, q: Quat) -> Sphere:
    return s


def rotate_capsule(c: Capsule, q: Quat) -> Capsule:
    """Rotate about the capsule's own center (geom.rs:1007-1013)."""
    center = capsule_center(c)
    return Capsule(a=center + qrotate(q, c.a - center), d=qrotate(q, c.d),
                   r=c.r)


# Volumetric dispatch rows: (rotate, center, set_pos) per shape type
_ROTATE = {
    Sphere: (rotate_sphere, lambda s: s.c, sphere_set_pos),
    Capsule: (rotate_capsule, capsule_center, capsule_set_pos),
    AABB: (rotate_aabb, lambda b: b.c, _aabb_set_pos),
    OBB: (rotate_obb, lambda b: b.c, _obb_set_pos),
}


def rotate_about(shape, q: Quat, origin: Vec3):
    """Volumetric::rotate_about (geom.rs:930-939): rotate the center about
    ``origin``, rotate the shape about its own center, and recenter."""
    rot, center, set_pos = _ROTATE[type(shape)]
    new_c = qrotate(q, center(shape) - origin) + origin
    return set_pos(rot(shape, q), new_c)


# support functions (Convex, geom.rs:1017-1072) -----------------------------

def _sign(v: Vec3) -> Vec3:
    """Rust f32::signum: sign(0) == +1 (``torch.sign(0)`` is 0)."""
    one = torch.ones_like(v.x)
    return Vec3(torch.where(v.x >= 0.0, one, -one),
                torch.where(v.y >= 0.0, one, -one),
                torch.where(v.z >= 0.0, one, -one))


def support_aabb(box: AABB, d: Vec3) -> Vec3:
    """geom.rs:1027-1034."""
    return box.c + vmul(_sign(d), box.r)


def support_obb(box: OBB, d: Vec3) -> Vec3:
    """geom.rs:1037-1048 (keeps the reference's missing recentering:
    rotate(sign * r) + c)."""
    dl = qrotate(qconj(box.q), d)
    return qrotate(box.q, vmul(_sign(dl), box.r)) + box.c


def support_sphere(s: Sphere, d: Vec3) -> Vec3:
    """geom.rs:1050-1053 (d expected normalized)."""
    return s.c + d * s.r


def support_capsule(c: Capsule, d: Vec3) -> Vec3:
    """geom.rs:1056-1072: cylinder-style support, radius on the axis."""
    center = c.a + c.d * 0.5
    h = magnitude(c.d)
    u = safe_normalize(c.d)
    ud = dot(u, d)
    w = d - u * ud
    sgn = torch.where(ud >= 0.0, 1.0, -1.0)
    axis_term = u * ((h * 0.5 + c.r) * sgn)
    w_ok = magnitude2(w) > 0.0
    zero = torch.zeros_like(ud)
    w_term = where_vec(w_ok, safe_normalize(w) * c.r, Vec3(zero, zero, zero))
    return center + axis_term + w_term


def compute_basis(n: Vec3):
    """Orthonormal tangent basis for a unit normal (geom.rs:1138-1145,
    from Box2D).  Returns (t1, t2)."""
    zero = torch.zeros_like(n.x)
    use_x = torch.abs(n.x) >= 0.57735
    b = where_vec(use_x, Vec3(n.y, -n.x, zero), Vec3(zero, n.z, -n.y))
    b = safe_normalize(b)
    return b, cross(n, b)

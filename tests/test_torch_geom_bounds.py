"""The port's shape library (mgf_tpu_torch.math3d, .geom, .bounds,
physics.obb_tensor and mesh.ConvexMesh) against mgf_tpu's.

tests/test_geom.py (11 tests) and tests/test_bounds.py (4) are replayed on
the port with their own goldens and tolerances.  Then every function this
slice ported runs on the same 4,096 random inputs through both packages
(numpy seed per case): a quarter of every direction's components are exactly
0 (sign(0) is +1 in both, ``torch.sign`` would give 0), and the shapes
include degenerate ones (zero radii and extents, zero-length capsules and
segments, collinear triangles, zero rotations).  Both packages run the same
float32 operations in the same order, one op at a time: booleans must be
equal, floats equal within rtol 1e-5 / atol 1e-6 (NaN where both are NaN).
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from mgf_tpu import bounds as j_bounds  # noqa: E402
from mgf_tpu import geom as j_geom  # noqa: E402
from mgf_tpu import math3d as j_m3  # noqa: E402
from mgf_tpu import mesh as j_mesh  # noqa: E402
from mgf_tpu import physics as j_physics  # noqa: E402

from mgf_tpu_torch import bounds as t_bounds  # noqa: E402
from mgf_tpu_torch import geom as t_geom  # noqa: E402
from mgf_tpu_torch import math3d as t_m3  # noqa: E402
from mgf_tpu_torch import mesh as t_mesh  # noqa: E402
from mgf_tpu_torch import physics as t_physics  # noqa: E402
from mgf_tpu_torch.bounds import (  # noqa: E402
    aabb_combine, aabb_sphere, aabb_surface_area, capsule_aabb, sphere_aabb,
    sphere_combine, swept_aabb, triangle_aabb,
)
from mgf_tpu_torch.collision import (  # noqa: E402
    contains_aabb_aabb, contains_sphere_sphere, overlap_aabb_aabb,
    overlap_sphere_sphere,
)
from mgf_tpu_torch.geom import (  # noqa: E402
    AABB, Capsule, Segment, Sphere, Triangle, closest_pt_triangle,
    closest_pts_seg, compute_basis, plane_from_points, support_aabb,
    support_capsule, support_sphere, triangle_barycentric,
)
from mgf_tpu_torch.math3d import (  # noqa: E402
    COLLISION_EPSILON, Vec3, dot, magnitude, magnitude2, mat_inv3, mat_mul,
    mfrom, mto, qrotate, quat_from_arc, vec3, vto,
)

CPU = "cpu"
N = 4096
TOL = dict(rtol=1e-5, atol=1e-6, equal_nan=True)


def V(x, y, z):
    return vec3(x, y, z, device=CPU)


def F(x):
    return torch.tensor(float(x))


def assert_vec(actual, expected, eps=1e-5):
    np.testing.assert_allclose(vto(actual).numpy(), vto(expected).numpy(),
                               atol=eps)


# ---------------------------------------------------------------------------
# tests/test_geom.py on the port
# ---------------------------------------------------------------------------

def test_tri_closest_pt():
    # geom.rs:1153-1161
    tri = Triangle(a=V(2.0, 3.5, 0.0), b=V(-2.0, -1.5, 0.0),
                   c=V(2.0, -1.5, 0.0))
    p = closest_pt_triangle(tri, V(0.0, 0.0, 0.0))
    assert float(magnitude2(p)) < COLLISION_EPSILON


def test_tri_closest_pt_regions():
    tri = Triangle(a=V(0, 0, 0), b=V(1, 0, 0), c=V(0, 1, 0))
    assert_vec(closest_pt_triangle(tri, V(-1, -1, 0)), V(0, 0, 0))
    assert_vec(closest_pt_triangle(tri, V(2, -1, 0)), V(1, 0, 0))
    assert_vec(closest_pt_triangle(tri, V(-1, 2, 0)), V(0, 1, 0))
    assert_vec(closest_pt_triangle(tri, V(0.5, -1, 0)), V(0.5, 0, 0))
    assert_vec(closest_pt_triangle(tri, V(1, 1, 0)), V(0.5, 0.5, 0))
    assert_vec(closest_pt_triangle(tri, V(0.25, 0.25, 5.0)),
               V(0.25, 0.25, 0))


def test_capsule_support_fn():
    # geom.rs:1169-1173
    cap = Capsule(a=V(2.0, 0.0, 0.0), d=V(2.0, 0.0, 0.0), r=F(1.0))
    assert_vec(support_capsule(cap, V(0.0, 1.0, 0.0)), V(5.0, 1.0, 0.0))
    assert_vec(support_capsule(cap, V(-1.0, 0.0, 0.0)), V(1.0, 0.0, 0.0))


def test_sphere_aabb_support():
    s = Sphere(c=V(1.0, 2.0, 3.0), r=F(2.0))
    assert_vec(support_sphere(s, V(0, 1, 0)), V(1, 4, 3))
    box = AABB(c=V(0, 0, 0), r=V(1, 2, 3))
    assert_vec(support_aabb(box, V(1, -1, 1)), V(1, -2, 3))


def test_closest_pts_seg():
    s1 = Segment(a=V(0, 0, 0), b=V(1, 0, 0))
    s2 = Segment(a=V(0.5, 1, 0), b=V(0.5, 2, 0))
    p1, p2, par = closest_pts_seg(s1, s2)
    assert not bool(par)
    assert_vec(p1, V(0.5, 0, 0))
    assert_vec(p2, V(0.5, 1, 0))
    # parallel overlapping segments report the parallel flag
    s3 = Segment(a=V(0, 1, 0), b=V(1, 1, 0))
    _, _, par = closest_pts_seg(s1, s3)
    assert bool(par)
    # degenerate (point) segments
    s4 = Segment(a=V(3, 4, 0), b=V(3, 4, 0))
    p1, p2, par = closest_pts_seg(s1, s4)
    assert not bool(par)
    assert_vec(p1, V(1, 0, 0))
    assert_vec(p2, V(3, 4, 0))


def test_plane_from_points():
    p = plane_from_points(V(0, 1, 0), V(0, 1, 1), V(1, 1, 0))
    assert_vec(p.n, V(0, 1, 0))
    assert float(p.d) == pytest.approx(1.0)


def test_barycentric():
    tri = Triangle(a=V(0, 0, 0), b=V(1, 0, 0), c=V(0, 1, 0))
    v, w, u = triangle_barycentric(tri, V(0.25, 0.25, 0.0))
    assert float(v) == pytest.approx(0.25)
    assert float(w) == pytest.approx(0.25)
    assert float(u) == pytest.approx(0.5)


def test_quat_from_arc():
    q = quat_from_arc(V(1, 0, 0), V(0, 1, 0))
    assert_vec(qrotate(q, V(1, 0, 0)), V(0, 1, 0))
    # parallel -> identity
    q = quat_from_arc(V(0, 2, 0), V(0, 5, 0))
    assert float(q.w) == pytest.approx(1.0)
    # antiparallel -> some 180-degree rotation
    q = quat_from_arc(V(0, 1, 0), V(0, -1, 0))
    assert_vec(qrotate(q, V(0, 1, 0)), V(0, -1, 0))
    # non-unit inputs
    q = quat_from_arc(V(3, 0, 0), V(0, 0, 7))
    assert_vec(qrotate(q, V(1, 0, 0)), V(0, 0, 1))


def test_compute_basis():
    for n in [V(0, 1, 0), V(1, 0, 0), V(0.6, 0.8, 0.0)]:
        t1, t2 = compute_basis(n)
        assert float(dot(t1, n)) == pytest.approx(0.0, abs=1e-6)
        assert float(dot(t2, n)) == pytest.approx(0.0, abs=1e-6)
        assert float(dot(t1, t2)) == pytest.approx(0.0, abs=1e-6)
        assert float(magnitude(t1)) == pytest.approx(1.0, rel=1e-5)
        assert float(magnitude(t2)) == pytest.approx(1.0, rel=1e-5)


def test_mat_inv3():
    m = mfrom(np.asarray([[2.0, 0, 0], [0, 4, 0], [1, 0, 8]], np.float32),
              device=CPU)
    inv = mat_inv3(m)
    np.testing.assert_allclose(mto(mat_mul(m, inv)).numpy(), np.eye(3),
                               atol=1e-6)


def test_native_batching():
    # every geom routine must accept batched component tensors directly
    ones = torch.ones(5)
    tri = Triangle(a=Vec3(ones * 0, ones * 0, ones * 0),
                   b=Vec3(ones, ones, ones),
                   c=Vec3(ones * 0, ones, ones * 0))
    pts = Vec3(ones * 0.3, ones * 0.3, ones * 0.3)
    out = closest_pt_triangle(tri, pts)
    assert out.x.shape == (5,)


# ---------------------------------------------------------------------------
# tests/test_bounds.py on the port (bounds.rs:321-411)
# ---------------------------------------------------------------------------

def test_aabb():
    # bounds.rs:330-350
    b1 = AABB(c=V(0, 0, 0), r=V(1, 1, 1))
    b2 = AABB(c=V(0, 2, 0), r=V(1, 1, 1))
    b3 = AABB(c=V(0, 3, 0), r=V(1, 1, 1))
    combined = aabb_combine(b1, b2)
    assert bool(overlap_aabb_aabb(b1, b2))
    assert not bool(overlap_aabb_aabb(b1, b3))
    assert not bool(contains_aabb_aabb(b1, b2))
    assert bool(contains_aabb_aabb(combined, b1))
    assert bool(contains_aabb_aabb(combined, b2))
    assert not bool(contains_aabb_aabb(combined, b3))


def test_sphere():
    # bounds.rs:353-373
    b1 = Sphere(c=V(0, 0, 0), r=F(1.0))
    b2 = Sphere(c=V(0, 2, 0), r=F(1.0))
    b3 = Sphere(c=V(0, 3, 0), r=F(1.0))
    combined = sphere_combine(b1, b2)
    assert bool(overlap_sphere_sphere(b1, b2))
    assert not bool(overlap_sphere_sphere(b1, b3))
    assert not bool(contains_sphere_sphere(b1, b2))
    assert bool(contains_sphere_sphere(combined, b1))
    assert bool(contains_sphere_sphere(combined, b2))
    assert not bool(contains_sphere_sphere(combined, b3))


def test_mixed():
    # bounds.rs:376-409
    b1 = Sphere(c=V(0, 0, 0), r=F(1.0))
    b2 = AABB(c=V(0, 2, 0), r=V(1, 1, 1))
    b3 = Sphere(c=V(0, 3, 0), r=F(1.0))
    combined_sphere = sphere_combine(b1, aabb_sphere(b2))
    combined_aabb = aabb_combine(sphere_aabb(b1), b2)
    assert not bool(contains_sphere_sphere(b1, aabb_sphere(b2)))
    assert bool(contains_sphere_sphere(combined_sphere, b1))
    assert bool(contains_sphere_sphere(combined_sphere, aabb_sphere(b2)))
    assert not bool(contains_sphere_sphere(combined_sphere, b3))
    assert bool(contains_aabb_aabb(combined_aabb, sphere_aabb(b1)))
    assert bool(contains_aabb_aabb(combined_aabb, b2))
    assert not bool(contains_aabb_aabb(combined_aabb, sphere_aabb(b3)))


def test_swept_and_shape_bounds():
    s = sphere_aabb(Sphere(c=V(0, 0, 0), r=F(1.0)))
    sw = swept_aabb(s, V(0, -4, 0))
    assert_vec(sw.c, V(0, -2, 0))
    assert_vec(sw.r, V(1, 3, 1))

    cap = Capsule(a=V(0, -1, 0), d=V(0, 2, 0), r=F(0.5))
    b = capsule_aabb(cap)
    # conservative cube: r + |d|/2 = 1.5 (bounds.rs:179-188)
    assert_vec(b.c, V(0, 0, 0))
    assert_vec(b.r, V(1.5, 1.5, 1.5))

    tri = Triangle(a=V(0, 0, 0), b=V(3, 0, 0), c=V(0, 3, 0))
    tb = triangle_aabb(tri)
    assert_vec(tb.c, V(1, 1, 0))
    assert_vec(tb.r, V(2, 2, 0))

    # surface_area is the reference's 1/8-quirk version (bounds.rs:132-134)
    assert float(aabb_surface_area(AABB(c=V(0, 0, 0), r=V(1, 2, 3)))) == 11.0


# ---------------------------------------------------------------------------
# batch parity against mgf_tpu on random inputs
# ---------------------------------------------------------------------------

def _ns(m3, geom, bounds, physics, mesh, arr):
    """One package's modules and its numpy -> Vec3 / Quat / scalar
    converters."""
    return types.SimpleNamespace(
        m3=m3, geom=geom, bounds=bounds, physics=physics, mesh=mesh,
        v=lambda a: m3.Vec3(*(arr(a[:, k]) for k in range(3))),
        q=lambda a: m3.Quat(*(arr(a[:, k]) for k in range(4))),
        s=arr)


J = _ns(j_m3, j_geom, j_bounds, j_physics, j_mesh, jnp.asarray)
T = _ns(t_m3, t_geom, t_bounds, t_physics, t_mesh,
        lambda a: torch.as_tensor(np.ascontiguousarray(a)))


def _inputs(seed):
    """Random shapes and directions, with zero components and degenerate
    shapes mixed in."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.uniform(-2, 2, s).astype(np.float32)

    def dirs():
        d = rng.standard_normal((N, 3)).astype(np.float32)
        d[rng.uniform(size=(N, 3)) < 0.25] = 0.0     # sign(0) lanes
        return d

    def pos(shape):
        r = rng.uniform(0.0, 1.5, shape).astype(np.float32)
        r[rng.uniform(size=shape) < 0.05] = 0.0       # degenerate
        return r

    q = rng.standard_normal((N, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[: N // 16] = [1.0, 0.0, 0.0, 0.0]               # axis-aligned boxes
    tri_c = f(N, 3)
    tri_c[: N // 32] = f(N // 32, 1) * np.float32([1, 2, -1])  # collinear
    seg_b = f(N, 3)
    seg_b[: N // 32] = 0.0
    return dict(a=f(N, 3), b=f(N, 3), c=tri_c, p=f(N, 3), d=dirs(),
                e=dirs(), q=q, q2=np.roll(q, 7, axis=0), r3=pos((N, 3)),
                r=pos(N), s=f(N), t=np.abs(f(N)), m=1.0 + np.abs(f(N)),
                seg_b=seg_b,
                u0=np.tile(np.float32([[1, 0, 0]]), (N, 1)),
                u1=np.tile(np.float32([[0, 0, 1]]), (N, 1)),
                hull=rng.standard_normal((40, 3)).astype(np.float32))


def _obb(P, x):
    return P.geom.OBB(c=P.v(x["a"]), q=P.q(x["q"]), r=P.v(x["r3"]))


def _cap(P, x):
    return P.geom.Capsule(a=P.v(x["a"]), d=P.v(x["seg_b"]), r=P.s(x["r"]))


def _tri(P, x):
    return P.geom.Triangle(a=P.v(x["a"]), b=P.v(x["b"]), c=P.v(x["c"]))


def _rect(P, x):
    return P.geom.Rectangle(c=P.v(x["a"]), u0=P.v(x["u0"]), u1=P.v(x["u1"]),
                            e0=P.s(x["t"]), e1=P.s(x["r"]))


def _sph(P, x):
    return P.geom.Sphere(c=P.v(x["a"]), r=P.s(x["r"]))


def _box(P, x):
    return P.geom.AABB(c=P.v(x["a"]), r=P.v(x["r3"]))


def _cm(P, x):
    pts = x["hull"]
    if P is J:
        return P.mesh.convex_mesh_from_points(pts, x=(0.5, -1.0, 2.0))
    return P.mesh.convex_mesh_from_points(pts, x=(0.5, -1.0, 2.0),
                                          device=CPU)


def _m3_ctor(P, x, name):
    kw = {} if P is J else dict(device=CPU)
    cols = x["d"].T if name == "vec3" else x["q"].T
    return getattr(P.m3, name)(*cols, **kw)


CASES = {
    # math3d
    "vmul": lambda P, x: P.m3.vmul(P.v(x["a"]), P.v(x["d"])),
    "vclamp": lambda P, x: P.m3.vclamp(P.v(x["p"]), P.v(x["a"]) - P.v(
        x["r3"]), P.v(x["a"]) + P.v(x["r3"])),
    "vall_le": lambda P, x: P.m3.vall_le(P.v(x["a"]), P.v(x["d"])),
    "qnorm2": lambda P, x: P.m3.qnorm2(P.q(x["q"]) * P.s(x["m"])),
    "quat_identity": lambda P, x: (
        P.m3.quat_identity((3, 2)) if P is J
        else P.m3.quat_identity((3, 2), device=CPU)),
    "mat_zero": lambda P, x: (P.m3.mat_zero((2,)) if P is J
                              else P.m3.mat_zero((2,), device=CPU)),
    "quat_from_axis_angle": lambda P, x: P.m3.quat_from_axis_angle(
        P.m3.safe_normalize(P.v(x["d"])), P.s(x["s"] * 3.0)),
    "vec3": lambda P, x: _m3_ctor(P, x, "vec3"),
    "quat": lambda P, x: _m3_ctor(P, x, "quat"),
    "vfrom_vto": lambda P, x: P.m3.vto(P.m3.vfrom(x["d"]) if P is J
                                       else P.m3.vfrom(x["d"], device=CPU)),
    "qfrom_qto": lambda P, x: P.m3.qto(P.m3.qfrom(x["q"]) if P is J
                                       else P.m3.qfrom(x["q"], device=CPU)),
    "mfrom_mto": lambda P, x: P.m3.mto(
        P.m3.mfrom(x["p"][:, None, :] * x["d"][:, :, None]) if P is J
        else P.m3.mfrom(x["p"][:, None, :] * x["d"][:, :, None],
                        device=CPU)),
    "safe_normalize_fallback": lambda P, x: P.m3.safe_normalize(
        P.v(x["d"]), P.v(x["a"]), eps=0.5),
    # geom
    "sign": lambda P, x: P.geom._sign(P.v(x["d"])),
    "plane_from_points": lambda P, x: P.geom.plane_from_points(
        P.v(x["a"]), P.v(x["b"]), P.v(x["c"])),
    "capsule_from_moving_sphere": lambda P, x:
        P.geom.capsule_from_moving_sphere(_sph(P, x), P.v(x["d"])),
    "ray_clamp": lambda P, x: P.geom.ray_clamp(
        P.geom.Ray(p=P.v(x["p"]), d=P.v(x["d"])), P.s(x["s"])),
    "triangle_normal": lambda P, x: P.geom.triangle_normal(_tri(P, x)),
    "triangle_barycentric": lambda P, x: P.geom.triangle_barycentric(
        _tri(P, x), P.v(x["p"])),
    "plane_center": lambda P, x: P.geom.plane_center(
        P.geom.plane_from_points(P.v(x["a"]), P.v(x["b"]), P.v(x["c"]))),
    "segment_center": lambda P, x: P.geom.segment_center(
        P.geom.Segment(a=P.v(x["a"]), b=P.v(x["seg_b"]))),
    "triangle_center": lambda P, x: P.geom.triangle_center(_tri(P, x)),
    "capsule_center": lambda P, x: P.geom.capsule_center(_cap(P, x)),
    "sphere_set_pos": lambda P, x: P.geom.sphere_set_pos(_sph(P, x),
                                                         P.v(x["p"])),
    "capsule_set_pos": lambda P, x: P.geom.capsule_set_pos(_cap(P, x),
                                                           P.v(x["p"])),
    "closest_pt_plane": lambda P, x: P.geom.closest_pt_plane(
        P.geom.plane_from_points(P.v(x["a"]), P.v(x["b"]), P.v(x["c"])),
        P.v(x["p"])),
    "closest_pt_ray": lambda P, x: P.geom.closest_pt_ray(
        P.geom.Ray(p=P.v(x["a"]), d=P.v(x["d"])), P.v(x["p"])),
    "closest_pt_triangle": lambda P, x: P.geom.closest_pt_triangle(
        _tri(P, x), P.v(x["p"])),
    "closest_pt_rectangle": lambda P, x: P.geom.closest_pt_rectangle(
        _rect(P, x), P.v(x["p"])),
    "closest_pt_aabb": lambda P, x: P.geom.closest_pt_aabb(_box(P, x),
                                                           P.v(x["p"])),
    "closest_pt_obb": lambda P, x: P.geom.closest_pt_obb(_obb(P, x),
                                                         P.v(x["p"])),
    "rotate_aabb": lambda P, x: P.geom.rotate_aabb(_box(P, x), P.q(x["q2"])),
    "rotate_obb": lambda P, x: P.geom.rotate_obb(_obb(P, x), P.q(x["q2"])),
    "rotate_sphere": lambda P, x: P.geom.rotate_sphere(_sph(P, x),
                                                       P.q(x["q2"])),
    "rotate_capsule": lambda P, x: P.geom.rotate_capsule(_cap(P, x),
                                                         P.q(x["q2"])),
    "rotate_about_sphere": lambda P, x: P.geom.rotate_about(
        _sph(P, x), P.q(x["q2"]), P.v(x["p"])),
    "rotate_about_capsule": lambda P, x: P.geom.rotate_about(
        _cap(P, x), P.q(x["q2"]), P.v(x["p"])),
    "rotate_about_aabb": lambda P, x: P.geom.rotate_about(
        _box(P, x), P.q(x["q2"]), P.v(x["p"])),
    "rotate_about_obb": lambda P, x: P.geom.rotate_about(
        _obb(P, x), P.q(x["q2"]), P.v(x["p"])),
    "support_aabb": lambda P, x: P.geom.support_aabb(_box(P, x),
                                                     P.v(x["d"])),
    "support_obb": lambda P, x: P.geom.support_obb(_obb(P, x), P.v(x["d"])),
    "support_sphere": lambda P, x: P.geom.support_sphere(
        _sph(P, x), P.m3.safe_normalize(P.v(x["d"]))),
    "support_capsule": lambda P, x: P.geom.support_capsule(
        _cap(P, x), P.m3.safe_normalize(P.v(x["d"]))),
    # bounds
    "aabb_combine": lambda P, x: P.bounds.aabb_combine(
        _box(P, x), P.geom.AABB(c=P.v(x["b"]), r=P.v(x["r3"][::-1]))),
    "aabb_surface_area": lambda P, x: P.bounds.aabb_surface_area(_box(P, x)),
    "aabb_expand": lambda P, x: P.bounds.aabb_expand(_box(P, x), 0.25),
    "aabb_scale": lambda P, x: P.bounds.aabb_scale(_box(P, x), P.s(x["s"])),
    "swept_aabb": lambda P, x: P.bounds.swept_aabb(_box(P, x), P.v(x["d"])),
    "sphere_combine": lambda P, x: P.bounds.sphere_combine(
        _sph(P, x), P.geom.Sphere(c=P.v(x["b"]), r=P.s(x["t"]))),
    "sphere_surface_area": lambda P, x: P.bounds.sphere_surface_area(
        _sph(P, x)),
    "swept_sphere": lambda P, x: P.bounds.swept_sphere(_sph(P, x),
                                                       P.v(x["d"])),
    "triangle_aabb": lambda P, x: P.bounds.triangle_aabb(_tri(P, x)),
    "rectangle_aabb": lambda P, x: P.bounds.rectangle_aabb(_rect(P, x)),
    "sphere_aabb": lambda P, x: P.bounds.sphere_aabb(_sph(P, x)),
    "capsule_aabb": lambda P, x: P.bounds.capsule_aabb(_cap(P, x)),
    "obb_aabb": lambda P, x: P.bounds.obb_aabb(_obb(P, x)),
    "triangle_sphere": lambda P, x: P.bounds.triangle_sphere(_tri(P, x)),
    "rectangle_sphere": lambda P, x: P.bounds.rectangle_sphere(_rect(P, x)),
    "aabb_sphere": lambda P, x: P.bounds.aabb_sphere(_box(P, x)),
    "capsule_sphere": lambda P, x: P.bounds.capsule_sphere(_cap(P, x)),
    "obb_sphere": lambda P, x: P.bounds.obb_sphere(_obb(P, x)),
    # physics, ConvexMesh
    "obb_tensor": lambda P, x: P.physics.obb_tensor(
        P.v(x["a"]), P.q(x["q"]), P.v(x["r3"]), P.s(x["m"])),
    "body_centers": lambda P, x: P.physics.body_centers(
        types.SimpleNamespace(x=P.v(x["a"]))),
    "convex_mesh_center": lambda P, x: P.mesh.convex_mesh_center(_cm(P, x)),
    "rotate_convex_mesh": lambda P, x: P.mesh.rotate_convex_mesh(
        _cm(P, x), P.q(x["q"][:1])),
    "support_convex_mesh": lambda P, x: P.mesh.support_convex_mesh(
        _cm(P, x), P.v(x["d"])),
}


def _leaves(tree):
    if isinstance(tree, tuple):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [np.asarray(tree)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_batch_parity(name):
    x = _inputs(sorted(CASES).index(name))
    fn = CASES[name]
    want = _leaves(fn(J, x))
    got = _leaves(fn(T, x))
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert g.shape == w.shape, (name, g.shape, w.shape)
        if w.dtype == bool:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, err_msg=name, **TOL)

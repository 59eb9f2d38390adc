"""The port's overlap, containment and ray/segment intersection tests
(mgf_tpu_torch.collision), local contacts and one-point manifolds against
mgf_tpu's.

tests/test_collision.py's test_ray_capsule_intersections, test_ray_misc and
test_overlaps_contains are replayed on the port with their goldens.  Then
every ``overlap_*``, ``contains_*`` and ``intersect_*`` runs on the same
4,096 random inputs through both packages (numpy seed per case), the
intersections for a ray (dt = inf) and a segment (dt = 1).  The rays
include directions with zero components (parallel to a slab), zero
directions, and starts inside the shape.  Booleans must be equal; t and the
hit point within 1e-5 + 1e-6 |value| where the ray hits: both packages run
the same float32 operations in the same order, but XLA on the CPU may fuse
a product into a sum, and a ray that meets a plane far away has t past 10,
where one float32 step is already 1e-6 of the value.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from mgf_tpu import collision as j_col  # noqa: E402
from mgf_tpu import geom as j_geom  # noqa: E402
from mgf_tpu import manifold as j_man  # noqa: E402
from mgf_tpu import math3d as j_m3  # noqa: E402

from mgf_tpu_torch import collision as t_col  # noqa: E402
from mgf_tpu_torch import geom as t_geom  # noqa: E402
from mgf_tpu_torch import manifold as t_man  # noqa: E402
from mgf_tpu_torch import math3d as t_m3  # noqa: E402
from mgf_tpu_torch.collision import (  # noqa: E402
    contains_aabb_aabb, contains_sphere_sphere, intersect_aabb,
    intersect_capsule, intersect_sphere, overlap_aabb_aabb,
    overlap_sphere_aabb, overlap_sphere_sphere,
)
from mgf_tpu_torch.geom import AABB, Capsule, Sphere  # noqa: E402
from mgf_tpu_torch.math3d import normalize, vec3, vto  # noqa: E402

CPU = "cpu"
N = 4096
INF = float("inf")


def V(x, y, z):
    return vec3(x, y, z, device=CPU)


def F(x):
    return torch.tensor(float(x))


def assert_vec(actual, expected, eps=1e-5):
    np.testing.assert_allclose(vto(actual).numpy(), vto(expected).numpy(),
                               atol=eps)


# ---------------------------------------------------------------------------
# tests/test_collision.py on the port
# ---------------------------------------------------------------------------

def test_ray_capsule_intersections():
    c = Capsule(a=V(0, 0, 0), d=V(1, 0, 0), r=F(1.0))
    d = normalize(V(-0.25, 1.0, 0.0))
    i = intersect_capsule(V(1, -3, 0), d, INF, c)
    assert bool(i.hit)
    assert_vec(i.p, V(0.5, -1.0, 0.0))

    d = normalize(V(0.25, 1.0, 0.0))
    i = intersect_capsule(V(0, -3, 0), d, INF, c)
    assert bool(i.hit)
    assert_vec(i.p, V(0.5, -1.0, 0.0))

    c2 = Capsule(a=V(0, 0, 0), d=V(0, 2, 0), r=F(2.0))
    i = intersect_capsule(V(4, 1, 0), V(-1, 0, 0), INF, c2)
    assert bool(i.hit)
    assert_vec(i.p, V(2, 1, 0))
    assert float(i.t) == pytest.approx(2.0)

    i = intersect_capsule(V(3, 0, 0), V(-1, 0, 0), INF, c)
    assert bool(i.hit)
    assert_vec(i.p, V(2, 0, 0))
    assert float(i.t) == pytest.approx(1.0)

    i = intersect_capsule(V(-2, 0, 0), V(1, 0, 0), INF, c)
    assert bool(i.hit)
    assert_vec(i.p, V(-1, 0, 0))
    assert float(i.t) == pytest.approx(1.0)

    # tangent-ish hit, golden t = 1.13397459621556196 (collision.rs:1608-1636)
    i = intersect_capsule(V(-2, 0.5, 0), V(1, 0, 0), INF, c)
    assert bool(i.hit)
    assert_vec(i.p, V(-0.8660254037844386, 0.5, 0.0))
    assert float(i.t) == pytest.approx(1.13397459621556196, abs=1e-5)

    i = intersect_capsule(V(3, 0.5, 0), V(-1, 0, 0), INF, c)
    assert bool(i.hit)
    assert_vec(i.p, V(1.8660254037844386, 0.5, 0.0))
    assert float(i.t) == pytest.approx(1.13397459621556196, abs=1e-5)


def test_ray_misc():
    s = Sphere(c=V(0, 0, 0), r=F(1.0))
    i = intersect_sphere(V(-3, 0, 0), V(1, 0, 0), INF, s)
    assert bool(i.hit) and float(i.t) == pytest.approx(2.0)
    i = intersect_sphere(V(-3, 2, 0), V(1, 0, 0), INF, s)
    assert not bool(i.hit)
    box = AABB(c=V(0, 0, 0), r=V(1, 1, 1))
    i = intersect_aabb(V(-3, 0, 0), V(1, 0, 0), INF, box)
    assert bool(i.hit) and float(i.t) == pytest.approx(2.0)
    i = intersect_aabb(V(-3, 0, 0), V(1, 0, 0), 1.0, box)
    assert not bool(i.hit)


def test_overlaps_contains():
    b1 = AABB(c=V(0, 0, 0), r=V(1, 1, 1))
    b2 = AABB(c=V(0, 2, 0), r=V(1, 1, 1))
    b3 = AABB(c=V(0, 3, 0), r=V(1, 1, 1))
    assert bool(overlap_aabb_aabb(b1, b2))
    assert not bool(overlap_aabb_aabb(b1, b3))
    assert not bool(contains_aabb_aabb(b1, b2))

    s1 = Sphere(c=V(0, 0, 0), r=F(1.0))
    s2 = Sphere(c=V(0, 2, 0), r=F(1.0))
    s3 = Sphere(c=V(0, 3, 0), r=F(1.0))
    assert bool(overlap_sphere_sphere(s1, s2))
    assert not bool(overlap_sphere_sphere(s1, s3))
    assert not bool(contains_sphere_sphere(s1, s2))
    assert bool(contains_sphere_sphere(s1, s1))  # closed volumes

    assert bool(overlap_sphere_aabb(s1, b1))
    assert not bool(overlap_sphere_aabb(s3, b1))


# ---------------------------------------------------------------------------
# batch parity against mgf_tpu on random inputs
# ---------------------------------------------------------------------------

def _ns(m3, geom, col, man, arr):
    return types.SimpleNamespace(
        m3=m3, geom=geom, col=col, man=man,
        v=lambda a: m3.Vec3(*(arr(a[:, k]) for k in range(3))),
        q=lambda a: m3.Quat(*(arr(a[:, k]) for k in range(4))),
        s=arr)


J = _ns(j_m3, j_geom, j_col, j_man, jnp.asarray)
T = _ns(t_m3, t_geom, t_col, t_man,
        lambda a: torch.as_tensor(np.ascontiguousarray(a)))


def _inputs(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.uniform(-2, 2, s).astype(np.float32)
    c = f(N, 3)
    p = rng.uniform(-4, 4, (N, 3)).astype(np.float32)
    p[: N // 8] = c[: N // 8]                   # starts inside the shape
    d = rng.standard_normal((N, 3)).astype(np.float32) * 3.0
    d[rng.uniform(size=(N, 3)) < 0.25] = 0.0    # parallel to a slab
    d[N // 8: N // 8 + N // 16] = 0.0           # zero directions
    q = rng.standard_normal((N, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[: N // 16] = [1.0, 0.0, 0.0, 0.0]
    u0 = rng.standard_normal((N, 3)).astype(np.float32)
    u0 /= np.linalg.norm(u0, axis=1, keepdims=True)
    u1 = np.cross(u0, rng.standard_normal((N, 3))).astype(np.float32)
    u1 /= np.linalg.norm(u1, axis=1, keepdims=True)
    r3 = rng.uniform(0.0, 1.5, (N, 3)).astype(np.float32)
    r = rng.uniform(0.0, 1.5, N).astype(np.float32)
    r[: N // 32] = 0.0
    return dict(c=c, c2=f(N, 3), p=p, d=d, q=q, u0=u0, u1=u1, r3=r3, r=r,
                r2=rng.uniform(0.0, 1.5, N).astype(np.float32),
                b=f(N, 3), e=f(N, 3), v=f(N, 3), t=rng.uniform(
                    0, 1, N).astype(np.float32),
                valid=rng.uniform(size=N) < 0.7)


def _box(P, x, c="c"):
    return P.geom.AABB(c=P.v(x[c]), r=P.v(x["r3"]))


def _sph(P, x, c="c", r="r"):
    return P.geom.Sphere(c=P.v(x[c]), r=P.s(x[r]))


def _tri(P, x):
    return P.geom.Triangle(a=P.v(x["c"]), b=P.v(x["b"]), c=P.v(x["e"]))


def _rect(P, x):
    return P.geom.Rectangle(c=P.v(x["c"]), u0=P.v(x["u0"]), u1=P.v(x["u1"]),
                            e0=P.s(x["r"]), e1=P.s(x["r2"]))


def _plane(P, x):
    return P.geom.plane_from_points(P.v(x["c"]), P.v(x["b"]), P.v(x["e"]))


def _on_plane(P, x):
    """Points on the triangle's plane, about half inside the triangle."""
    u = x["t"][:, None] * 1.3 - 0.3
    v = x["t"][::-1, None] * 1.3 - 0.3
    return P.v(x["c"] + (x["b"] - x["c"]) * u + (x["e"] - x["c"]) * v)


PREDICATES = {
    "overlap_aabb_aabb": lambda P, x: P.col.overlap_aabb_aabb(
        _box(P, x), _box(P, x, "c2")),
    "overlap_sphere_aabb": lambda P, x: P.col.overlap_sphere_aabb(
        _sph(P, x, "c2"), _box(P, x)),
    "overlap_sphere_sphere": lambda P, x: P.col.overlap_sphere_sphere(
        _sph(P, x), _sph(P, x, "c2", "r2")),
    "contains_plane_pt": lambda P, x: P.col.contains_plane_pt(
        _plane(P, x), _on_plane(P, x)),
    "contains_triangle_pt": lambda P, x: P.col.contains_triangle_pt(
        _tri(P, x), _on_plane(P, x)),
    "contains_rectangle_pt": lambda P, x: P.col.contains_rectangle_pt(
        _rect(P, x), P.v(x["c"] + x["u0"] * x["b"][:, :1]
                         + x["u1"] * x["b"][:, 1:2])),
    "contains_aabb_pt": lambda P, x: P.col.contains_aabb_pt(
        _box(P, x), P.v(x["p"])),
    "contains_sphere_pt": lambda P, x: P.col.contains_sphere_pt(
        _sph(P, x), P.v(x["p"])),
    "contains_aabb_aabb": lambda P, x: P.col.contains_aabb_aabb(
        _box(P, x), P.geom.AABB(c=P.v(x["c"] + x["v"] * 0.2),
                                r=P.v(x["r3"] * 0.5))),
    "contains_sphere_sphere": lambda P, x: P.col.contains_sphere_sphere(
        _sph(P, x), P.geom.Sphere(c=P.v(x["c"] + x["v"] * 0.2),
                                  r=P.s(x["r2"] * 0.5))),
}

INTERSECTS = {
    "intersect_plane": lambda P, x, dt: P.col.intersect_plane(
        P.v(x["p"]), P.v(x["d"]), dt, _plane(P, x)),
    "intersect_triangle": lambda P, x, dt: P.col.intersect_triangle(
        P.v(x["p"]), P.v(x["d"]), dt, _tri(P, x)),
    "intersect_rectangle": lambda P, x, dt: P.col.intersect_rectangle(
        P.v(x["p"]), P.v(x["d"]), dt, _rect(P, x)),
    "intersect_aabb": lambda P, x, dt: P.col.intersect_aabb(
        P.v(x["p"]), P.v(x["d"]), dt, _box(P, x)),
    "intersect_obb": lambda P, x, dt: P.col.intersect_obb(
        P.v(x["p"]), P.v(x["d"]), dt,
        P.geom.OBB(c=P.v(x["c"]), q=P.q(x["q"]), r=P.v(x["r3"]))),
    "intersect_sphere": lambda P, x, dt: P.col.intersect_sphere(
        P.v(x["p"]), P.v(x["d"]), dt, _sph(P, x)),
    "intersect_capsule": lambda P, x, dt: P.col.intersect_capsule(
        P.v(x["p"]), P.v(x["d"]), dt,
        P.geom.Capsule(a=P.v(x["c"]), d=P.v(x["v"]), r=P.s(x["r"]))),
    "intersect_moving_sphere": lambda P, x, dt:
        P.col.intersect_moving_sphere(P.v(x["p"]), P.v(x["d"]), dt,
                                      _sph(P, x), P.v(x["v"])),
}


def _contact(P, x):
    return P.col.Contact(a=P.v(x["c"]), b=P.v(x["b"]),
                         n=P.m3.safe_normalize(P.v(x["d"])), t=P.s(x["t"]),
                         valid=P.s(x["valid"]))


def _local(P, x):
    return P.col.local_contact(_contact(P, x), P.v(x["c2"]), P.v(x["v"]),
                               P.v(x["e"]), P.v(x["d"]))


CONTACTS = {
    "local_contact": _local,
    "manifold_from_local_contact": lambda P, x:
        P.man.manifold_from_local_contact(_local(P, x)),
    "slot": lambda P, x: P.man.slot(P.col.contact_stack(
        [_contact(P, x), P.col.contact_neg(_contact(P, x))]), 1),
}


def _leaves(tree):
    if isinstance(tree, tuple):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [np.asarray(tree)]


@pytest.mark.parametrize("name", sorted(PREDICATES))
def test_predicate_parity(name):
    x = _inputs(sorted(PREDICATES).index(name))
    want = np.asarray(PREDICATES[name](J, x))
    got = PREDICATES[name](T, x).numpy()
    assert want.dtype == bool and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < N            # both outcomes are exercised


@pytest.mark.parametrize("dt", [1.0, INF], ids=["segment", "ray"])
@pytest.mark.parametrize("name", sorted(INTERSECTS))
def test_intersect_parity(name, dt):
    x = _inputs(100 + sorted(INTERSECTS).index(name))
    want = INTERSECTS[name](J, x, dt)
    got = INTERSECTS[name](T, x, dt)
    hit = np.asarray(want.hit)
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    assert 0 < hit.sum() < N
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit],
                               rtol=1e-6, atol=1e-5)
    for g, w in zip(got.p, want.p):
        np.testing.assert_allclose(g.numpy()[hit], np.asarray(w)[hit],
                                   rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("name", sorted(CONTACTS))
def test_contact_parity(name):
    x = _inputs(200 + sorted(CONTACTS).index(name))
    want = _leaves(CONTACTS[name](J, x))
    got = _leaves(CONTACTS[name](T, x))
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert g.shape == w.shape
        if w.dtype == bool:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)

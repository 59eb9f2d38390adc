"""Parity of the port's sphere narrowphase (mgf_tpu_torch.collision,
mgf_tpu_torch.manifold) with mgf_tpu's, on the same numpy inputs.

Both sides run eagerly on the CPU.  Tolerance atol 1e-5 on t, n and the
contact points: XLA's and torch's CPU kernels may round sqrt and division
differently in the last ulp, and the quadratic sweep solve amplifies that
to ~1e-6; validity masks must agree exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mgf_tpu import collision as jcol  # noqa: E402
from mgf_tpu import geom as jgeom  # noqa: E402
from mgf_tpu import manifold as jman  # noqa: E402
from mgf_tpu.math3d import Vec3 as JVec3  # noqa: E402

from mgf_tpu_torch import collision as tcol  # noqa: E402
from mgf_tpu_torch import geom as tgeom  # noqa: E402
from mgf_tpu_torch import manifold as tman  # noqa: E402
from mgf_tpu_torch.math3d import Vec3 as TVec3  # noqa: E402

ATOL = 1e-5
N = 4096


def _jv(a):
    return JVec3(*(jnp.asarray(a[..., k]) for k in range(3)))


def _tv(a):
    return TVec3(*(torch.as_tensor(np.ascontiguousarray(a[..., k]))
                   for k in range(3)))


def _np(x):
    if isinstance(x, tuple):
        return np.stack([_np(c) for c in x], axis=-1)
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _assert_contacts(cj, ct, atol=ATOL):
    vj, vt = _np(cj.valid), _np(ct.valid)
    np.testing.assert_array_equal(vj, vt)
    assert vj.any()
    for f in ("t", "n", "a", "b"):
        a, b = _np(getattr(cj, f)), _np(getattr(ct, f))
        np.testing.assert_allclose(a[vj], b[vj], atol=atol, rtol=0,
                                   err_msg=f)


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def test_sphere_moving_sphere_random_batch():
    rng = np.random.default_rng(0)
    c1 = _f32(rng, N, 3, scale=1.5)
    c2 = _f32(rng, N, 3, scale=1.5)
    r1 = rng.uniform(0.2, 1.0, N).astype(np.float32)
    r2 = rng.uniform(0.2, 1.0, N).astype(np.float32)
    va = _f32(rng, N, 3, scale=1.0)
    vb = _f32(rng, N, 3, scale=1.0)
    va[:64] = 0.0                          # coincident-velocity lanes
    vb[:64] = 0.0
    c2[64:96] = c1[64:96]                  # coincident centers
    cj = jcol.contact_moving_moving(
        jcol.contact_sphere_moving_sphere,
        jgeom.Sphere(c=_jv(c1), r=jnp.asarray(r1)), _jv(va),
        jgeom.Sphere(c=_jv(c2), r=jnp.asarray(r2)), _jv(vb))
    ct = tcol.contact_moving_moving(
        tcol.contact_sphere_moving_sphere,
        tgeom.Sphere(c=_tv(c1), r=torch.as_tensor(r1)), _tv(va),
        tgeom.Sphere(c=_tv(c2), r=torch.as_tensor(r2)), _tv(vb))
    _assert_contacts(cj, ct)
    # both branches occur: resting overlaps (t == 0) and swept hits
    t = _np(cj.t)[_np(cj.valid)]
    assert (t == 0).any() and (t > 0).any()


def test_triangle_moving_sphere_random_batch():
    """Against mgf_tpu's routine compiled (``jax.jit``), as its step runs
    it: the edge tests' ``intersect_capsule`` fuses each multiply-add as
    XLA does (see collision._fma)."""
    rng = np.random.default_rng(1)
    a = _f32(rng, N, 3, scale=2.0)
    b = a + _f32(rng, N, 3, scale=2.0)
    c = a + _f32(rng, N, 3, scale=2.0)
    centroid = (a + b + c) / 3.0
    s = (centroid + _f32(rng, N, 3, scale=1.0)).astype(np.float32)
    r = rng.uniform(0.2, 1.0, N).astype(np.float32)
    v = _f32(rng, N, 3, scale=1.5)
    cj = jax.jit(jcol.contact_triangle_moving_sphere)(
        jgeom.Triangle(_jv(a), _jv(b), _jv(c)),
        jgeom.Sphere(c=_jv(s), r=jnp.asarray(r)), _jv(v))
    ct = tcol.contact_triangle_moving_sphere(
        tgeom.Triangle(_tv(a), _tv(b), _tv(c)),
        tgeom.Sphere(c=_tv(s), r=torch.as_tensor(r)), _tv(v))
    _assert_contacts(cj, ct)


def test_intersect_capsule_long_edge_matches_compiled():
    """Spheres falling onto the demo box floor's 28-unit diagonal edge: the
    edge quadratic cancels ~2e5-sized terms, so float32 t moves in steps of
    ~2e-4 with the rounding order.  The port fuses the multiply-adds as
    mgf_tpu's compiled routine does: t within 1e-6 of it on every hit lane
    (evaluated op by op, the two differ by up to 4.4e-3 on these lanes)."""
    rng = np.random.default_rng(7)
    x = rng.uniform(-9.0, 9.0, N)
    pos = np.stack([x, -9.5 + rng.uniform(-0.1, 0.1, N),
                    -x + rng.uniform(-1e-3, 1e-3, N)], -1).astype(np.float32)
    d = np.stack([rng.uniform(-0.01, 0.01, N), -rng.uniform(0.05, 0.3, N),
                  rng.uniform(-0.01, 0.01, N)], -1).astype(np.float32)
    ca = np.broadcast_to(np.float32([-10, -10, 10]), (N, 3))
    cd = np.broadcast_to(np.float32([20, 0, -20]), (N, 3))
    r = rng.uniform(0.3, 0.6, N).astype(np.float32)
    ij = jax.jit(lambda p_, d_, a_, c_, r_: jcol.intersect_capsule(
        p_, d_, jnp.inf, jgeom.Capsule(a_, c_, r_)))(
        _jv(pos), _jv(d), _jv(ca), _jv(cd), jnp.asarray(r))
    it = tcol.intersect_capsule(_tv(pos), _tv(d), float("inf"),
                                tgeom.Capsule(_tv(ca), _tv(cd),
                                              torch.as_tensor(r)))
    hit = _np(ij.hit)
    np.testing.assert_array_equal(hit, _np(it.hit))
    assert hit.sum() > N // 2
    np.testing.assert_allclose(_np(it.t)[hit], _np(ij.t)[hit], atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("slots", [1, 2])
def test_prune_one_slot_random_batch(slots):
    rng = np.random.default_rng(2 + slots)
    sh = (slots, N)
    t = rng.uniform(0.0, 1.0, sh).astype(np.float32)
    t[:, :500] = 0.0                      # same-time slots (merge path)
    valid = rng.uniform(size=sh) < 0.8
    pts = [_f32(rng, *sh, 3) for _ in range(4)]
    n = _f32(rng, *sh, 3)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)

    def build(vec, arr, cons, lc):
        c = cons(a=vec(pts[0]), b=vec(pts[1]), n=vec(n), t=arr(t),
                 valid=arr(valid))
        return lc(local_a=vec(pts[2]), local_b=vec(pts[3]), contact=c)

    mj = jman.prune(build(_jv, jnp.asarray, jcol.Contact, jcol.LocalContact),
                    max_contacts=1)
    mt = tman.prune(build(_tv, torch.as_tensor, tcol.Contact,
                          tcol.LocalContact), max_contacts=1)
    vj = _np(mj.valid)
    np.testing.assert_array_equal(vj, _np(mt.valid))
    for f in ("time", "normal", "t1", "t2"):
        np.testing.assert_allclose(_np(getattr(mj, f)), _np(getattr(mt, f)),
                                   atol=ATOL, rtol=0, err_msg=f)
    for f in ("local_a", "local_b"):
        np.testing.assert_allclose(_np(getattr(mj, f))[vj],
                                   _np(getattr(mt, f))[vj], atol=ATOL,
                                   rtol=0, err_msg=f)


def _helper_cases():
    """{name: (mgf_tpu thunk, port thunk)} for the algebra helpers the
    slice ports beside the contacts, on one shared random batch."""
    from mgf_tpu import math3d as jm, physics as jp
    from mgf_tpu_torch import math3d as tm, physics as tp
    rng = np.random.default_rng(5)
    v = _f32(rng, N, 3)
    v[:8] = [1.0, 0.0, 0.0]                     # the x-axis fallback lanes
    q = _f32(rng, N, 4)
    p = _f32(rng, N, 4)
    r = rng.uniform(0.2, 1.0, N).astype(np.float32)
    m = rng.uniform(0.5, 2.0, N).astype(np.float32)
    pn = _f32(rng, N, 3)
    pn /= np.linalg.norm(pn, axis=-1, keepdims=True)
    pd = _f32(rng, N)
    jq = lambda a: jm.Quat(*(jnp.asarray(a[:, k]) for k in range(4)))
    tq = lambda a: tm.Quat(*(torch.as_tensor(np.ascontiguousarray(a[:, k]))
                             for k in range(4)))
    return {
        "perpendicular": (lambda: jm.perpendicular(_jv(v)),
                          lambda: tm.perpendicular(_tv(v))),
        "qmul_qnormalize": (lambda: jm.qnormalize(jm.qmul(jq(p), jq(q))),
                            lambda: tm.qnormalize(tm.qmul(tq(p), tq(q)))),
        "sphere_tensor": (
            lambda: jp.sphere_tensor(_jv(v), jnp.asarray(r), jnp.asarray(m)),
            lambda: tp.sphere_tensor(_tv(v), torch.as_tensor(r),
                                     torch.as_tensor(m))),
        "intersect_plane": (
            lambda: jcol.intersect_plane(
                _jv(v), _jv(pn[::-1].copy()), 1.0,
                jgeom.Plane(n=_jv(pn), d=jnp.asarray(pd))),
            lambda: tcol.intersect_plane(
                _tv(v), _tv(pn[::-1].copy()), 1.0,
                tgeom.Plane(n=_tv(pn), d=torch.as_tensor(pd)))),
        "compute_basis": (lambda: jgeom.compute_basis(_jv(pn)),
                          lambda: tgeom.compute_basis(_tv(pn))),
    }


@pytest.mark.parametrize("name", ["perpendicular", "qmul_qnormalize",
                                  "sphere_tensor", "intersect_plane",
                                  "compute_basis"])
def test_algebra_helpers_match_jax(name):
    fj, ft = _helper_cases()[name]
    lj, lt = _flat(fj()), _flat(ft())
    assert len(lj) == len(lt)
    for a, b in zip(lj, lt):
        np.testing.assert_allclose(_np(a), _np(b), atol=ATOL, rtol=1e-6)


def _flat(x):
    if isinstance(x, tuple):
        return [leaf for c in x for leaf in _flat(c)]
    return [x]


# ---------------------------------------------------------------------------
# replays of tests/test_collision.py on the port (collision.rs goldens)
# ---------------------------------------------------------------------------

def V(x, y, z):
    return TVec3(*(torch.tensor(float(c)) for c in (x, y, z)))


def F(x):
    return torch.tensor(float(x))


def assert_vec(actual, expected, eps=1e-5):
    np.testing.assert_allclose(_np(actual), _np(expected), atol=eps)


def test_moving_spheres_collision():
    s1 = tgeom.Sphere(c=V(-3, 0, 0), r=F(1.0))
    s2 = tgeom.Sphere(c=V(3, 0, 0), r=F(2.0))
    c = tcol.contact_moving_moving(tcol.contact_sphere_moving_sphere,
                                   s1, V(1, 0, 0), s2, V(-2, 0, 0))
    assert bool(c.valid)
    assert float(c.t) == pytest.approx(1.0)
    assert_vec(c.a, V(-1, 0, 0))
    assert_vec(c.b, V(-1, 0, 0))
    assert_vec(c.n, V(1, 0, 0))


def test_tri_sphere_collision():
    floor = tgeom.Triangle(a=V(1, 1, 0), b=V(0, 1, -1), c=V(0, 1, 1))
    s = tgeom.Sphere(c=V(0, 13, 0), r=F(2.0))

    c = tcol.contact_triangle_moving_sphere(floor, s, V(0, -10, 0))
    assert bool(c.valid)
    assert_vec(c.a, V(0, 1, 0))
    assert float(c.t) == pytest.approx(1.0)
    assert_vec(c.n, V(0, 1, 0))

    c = tcol.contact_triangle_moving_sphere(floor, s, V(0, -10, 1))
    assert bool(c.valid)
    assert_vec(c.a, V(0, 1, 1))
    assert float(c.t) == pytest.approx(1.0, abs=1e-5)

    c = tcol.contact_triangle_moving_sphere(floor, s, V(0, -10, 1.00001))
    assert not bool(c.valid)

    c = tcol.contact_triangle_moving_sphere(floor, s, V(0.5, -10, 0.5))
    assert bool(c.valid)
    assert_vec(c.a, V(0.5, 1, 0.5))
    assert float(c.t) == pytest.approx(1.0)


def test_plane_moving_sphere():
    p = tgeom.Plane(n=V(0, 1, 0), d=F(0.0))
    s = tgeom.Sphere(c=V(0, 5, 0), r=F(1.0))
    c = tcol.contact_plane_moving_sphere(p, s, V(0, -4, 0))
    assert bool(c.valid)
    assert float(c.t) == pytest.approx(1.0)
    assert_vec(c.a, V(0, 0, 0))
    # resting contact
    s = tgeom.Sphere(c=V(0, 0.5, 0), r=F(1.0))
    c = tcol.contact_plane_moving_sphere(p, s, V(0, 0, 0))
    assert bool(c.valid)
    assert float(c.t) == pytest.approx(0.0)
    assert_vec(c.a, V(0, 0, 0))
    assert_vec(c.b, V(0, -0.5, 0))
    # moving away
    s = tgeom.Sphere(c=V(0, 5, 0), r=F(1.0))
    c = tcol.contact_plane_moving_sphere(p, s, V(0, 4, 0))
    assert not bool(c.valid)

"""Parity of the port's capsule physics (mgf_tpu_torch.physics and the
math3d routines it needs) with mgf_tpu's, on the same numpy inputs.

Both sides run on the CPU.  Tolerances:

* ``quat_from_arc``, ``quat_to_mat``, ``mat_mul``, ``mat_t``, ``mat_inv3``,
  ``qrotate``: atol 1e-6 (plus rtol 1e-6 on the triple product R D R^T,
  whose entries reach 5, and rtol 1e-5 on the inverse, whose entries reach
  1e3);
* ``capsule_tensor``: rtol 1e-6 of each tensor's largest entry;
* ``SceneBuilder`` with capsules: every array exact (both classes are the
  same numpy code);
* ``integrate(iso=False)``: a spinning capsule stepped 200 times in each
  package from the same state; q and the world inverse inertia atol 1e-5
  after the last step, not only after the first (the quaternion is
  renormalised and the inertia rotated every step, so drift would show).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mgf_tpu import math3d as jm  # noqa: E402
from mgf_tpu import physics as jphys  # noqa: E402

from mgf_tpu_torch import math3d as tm  # noqa: E402
from mgf_tpu_torch import physics as tphys  # noqa: E402
from mgf_tpu_torch import world_from_numpy, world_to_numpy  # noqa: E402


def _jv(a):
    return jm.Vec3(*(jnp.asarray(a[..., k]) for k in range(3)))


def _tv(a):
    return tm.Vec3(*(torch.as_tensor(np.ascontiguousarray(a[..., k]))
                     for k in range(3)))


def _np(x):
    if isinstance(x, tuple):
        return np.stack([_np(c) for c in x], axis=-1)
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def test_quat_and_mat_helpers_match_jax():
    rng = np.random.default_rng(41)
    n = 2048
    src, dst = _f32(rng, n, 3), _f32(rng, n, 3)
    dst[::8] = -src[::8] * 2.0           # antiparallel: the pi-spin branch
    dst[1::8] = src[1::8] * 0.5          # parallel
    qj = jm.quat_from_arc(_jv(src), _jv(dst))
    qt = tm.quat_from_arc(_tv(src), _tv(dst))
    np.testing.assert_allclose(_np(qj), _np(qt), atol=1e-6, rtol=0)
    # the arc really maps src onto dst's direction
    rot = _np(tm.qrotate(qt, _tv(src)))
    cosang = np.sum(rot * dst, -1) / (np.linalg.norm(rot, axis=-1)
                                      * np.linalg.norm(dst, axis=-1))
    assert cosang.min() > 1.0 - 1e-4
    np.testing.assert_allclose(_np(jm.qrotate(qj, _jv(dst))),
                               _np(tm.qrotate(qt, _tv(dst))), atol=1e-6,
                               rtol=0)
    mj, mt = jm.quat_to_mat(qj), tm.quat_to_mat(qt)
    np.testing.assert_allclose(_np(mj), _np(mt), atol=1e-6, rtol=0)
    dj = jm.mat_diag(*(jnp.asarray(c) for c in (src[:, 0], src[:, 1],
                                                src[:, 2])))
    dt = tm.mat_diag(*(torch.as_tensor(np.ascontiguousarray(c))
                       for c in (src[:, 0], src[:, 1], src[:, 2])))
    pj = jm.mat_mul(jm.mat_mul(mj, dj), jm.mat_t(mj))
    pt = tm.mat_mul(tm.mat_mul(mt, dt), tm.mat_t(mt))
    np.testing.assert_allclose(_np(pj), _np(pt), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(_np(jm.mat_inv3(pj)), _np(tm.mat_inv3(pt)),
                               atol=1e-6, rtol=1e-5)
    r3 = tm.mat3_rows(_tv(src), _tv(dst), _tv(src))
    np.testing.assert_array_equal(_np(r3)[:, 3:6], dst)
    np.testing.assert_allclose(_np(tm.magnitude(_tv(src))),
                               np.linalg.norm(src, axis=-1), rtol=1e-6)
    np.testing.assert_array_equal(_np(tm.vabs(_tv(src))), np.abs(src))
    np.testing.assert_array_equal(
        _np(tm.clamp(torch.as_tensor(src[:, 0]), -0.5, 0.5)),
        np.clip(src[:, 0], -0.5, 0.5))


def test_mat_inv3_singular_lanes_are_zero():
    z = torch.zeros(4)
    m = tm.Mat3(*([z] * 9))
    assert all(float(c.abs().max()) == 0.0 for c in tm.mat_inv3(m))


def test_capsule_tensor_matches_jax():
    rng = np.random.default_rng(42)
    n = 2048
    a, d = _f32(rng, n, 3, scale=2.0), _f32(rng, n, 3)
    d[::8] = np.asarray([0.0, -1.5, 0.0], np.float32)    # antiparallel to y
    r = rng.uniform(0.2, 1.5, n).astype(np.float32)
    m = rng.uniform(0.5, 4.0, n).astype(np.float32)
    tj = jphys.capsule_tensor(_jv(a), _jv(d), jnp.asarray(r), jnp.asarray(m))
    tt = tphys.capsule_tensor(_tv(a), _tv(d), torch.as_tensor(r),
                              torch.as_tensor(m))
    j, t = _np(tj), _np(tt)
    scale = np.abs(j).max(axis=-1, keepdims=True)
    # rtol 1e-6 of each tensor's largest entry (the off-diagonal entries
    # are differences of products of that size)
    np.testing.assert_allclose(j / scale, t / scale, atol=1e-6, rtol=0)
    # symmetric
    np.testing.assert_allclose(t[:, 1], t[:, 3], atol=1e-5)


def _capsule_batch(sb):
    rng = np.random.default_rng(43)
    n = 64
    a = rng.uniform(-3, 3, (n, 3))
    d = rng.standard_normal((n, 3))
    d[0] = (0.0, -1.0, 0.0)              # antiparallel to y: pi around x
    d[1] = (0.0, 2.0, 0.0)
    sb.add_spheres(rng.uniform(-3, 3, (5, 3)).astype(np.float32), 0.5,
                        mass=1.0, restitution=0.3, friction=0.6)
    sb.add_capsules(a, d, rng.uniform(0.2, 1.0, n), mass=2.0,
                         restitution=0.3, friction=0.6)
    sb.add_capsule((0.0, 5.0, 0.0), (1.0, 0.0, 0.0), 0.5, mass=1.0,
                        restitution=0.1, friction=0.2)
    sb.add_capsules(a[:3] + 10.0, d[:3], 0.5, mass=np.inf,
                         restitution=0.0, friction=0.5,
                         gravity=(0.0, 0.0, 0.0))
    return sb


def test_scene_builder_capsules_match_jax():
    js = _capsule_batch(jphys.SceneBuilder()).build()
    ts = _capsule_batch(tphys.SceneBuilder()).build("cpu")
    a = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, js))
    b = jax.tree_util.tree_leaves(world_to_numpy(ts))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
    assert int(ts.shape_type.sum()) == 68
    # the static capsules have no inverse mass and no inverse inertia
    assert float(ts.inv_mass[-3:].abs().max()) == 0.0
    assert all(float(c[-3:].abs().max()) == 0.0 for c in ts.inv_moment_body)
    np.testing.assert_array_equal(
        jphys._np_quat_from_arc_y(np.asarray([[0.0, -1.0, 0.0]])),
        tphys._np_quat_from_arc_y(np.asarray([[0.0, -1.0, 0.0]])))


@pytest.mark.parametrize("kw,msg", [
    (dict(radii=0.0, mass=1.0), "radius"),
    (dict(radii=-1.0, mass=1.0), "radius"),
    (dict(radii=0.5, mass=0.0), "mass"),
])
def test_add_capsules_validates(kw, msg):
    b = tphys.SceneBuilder()
    with pytest.raises(ValueError, match=msg):
        b.add_capsules(np.zeros((2, 3)), np.ones((2, 3)), restitution=0.3,
                       friction=0.6, **kw)


def test_colliders_and_axis_match_jax():
    js = _capsule_batch(jphys.SceneBuilder()).build()
    ts = _capsule_batch(tphys.SceneBuilder()).build("cpu")
    np.testing.assert_allclose(_np(jphys.capsule_axis(js)),
                               _np(tphys.capsule_axis(ts)), atol=1e-6,
                               rtol=0)
    (sj, cj), (st, ct) = jphys.colliders(js), tphys.colliders(ts)
    np.testing.assert_array_equal(_np(sj.c), _np(st.c))
    for f in ("a", "d"):
        np.testing.assert_allclose(_np(getattr(cj, f)), _np(getattr(ct, f)),
                                   atol=1e-6, rtol=0)
    np.testing.assert_array_equal(_np(cj.r), _np(ct.r))


def test_integrate_spinning_capsules_200_steps():
    """integrate(iso=False) renormalises q and rotates the inverse inertia
    every step: hold both after 200 steps of spinning, torqued capsules."""
    rng = np.random.default_rng(44)
    js = _capsule_batch(jphys.SceneBuilder()).build()
    n = js.n_bodies
    om = _f32(rng, n, 3, scale=4.0)
    tq = _f32(rng, n, 3, scale=0.5)
    js = js._replace(omega=_jv(om), torque=_jv(tq))
    ts = world_from_numpy(jax.tree_util.tree_map(np.asarray, js), "cpu")
    dt = 1.0 / 60.0
    jf = jax.jit(functools.partial(jphys.integrate, dt=dt, iso=False))
    first = None
    for k in range(200):
        js = jphys.complete_motion(jf(js))
        ts = tphys.complete_motion(tphys.integrate(ts, dt, iso=False))
        if k == 0:
            first = (_np(js.inv_moment), _np(ts.inv_moment))
    np.testing.assert_allclose(*first, atol=1e-5, rtol=1e-5)
    dyn = np.asarray(js.inv_mass) > 0
    qj, qt = _np(js.q), _np(ts.q)
    np.testing.assert_allclose(qj, qt, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(qt, axis=-1), 1.0, atol=1e-5)
    ij, it = _np(js.inv_moment), _np(ts.inv_moment)
    scale = np.abs(ij).max(axis=-1, keepdims=True) + 1e-9
    np.testing.assert_allclose(ij[dyn] / scale[dyn], it[dyn] / scale[dyn],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(js.omega), _np(ts.omega), atol=1e-4,
                               rtol=1e-5)
    for f in ("x", "v"):
        np.testing.assert_allclose(_np(getattr(js, f)), _np(getattr(ts, f)),
                                   atol=1e-4, rtol=1e-5, err_msg=f)
    # the capsules really turned: q moved away from its start
    assert np.abs(qt[5:] - _np(_capsule_batch(
        tphys.SceneBuilder()).build("cpu").q)[5:]).max() > 0.5
    # iso=True leaves the inertia alone, as for spheres
    t_iso = tphys.integrate(ts, dt, iso=True)
    assert t_iso.inv_moment is ts.inv_moment_body

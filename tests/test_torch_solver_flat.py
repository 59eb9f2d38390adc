"""Parity of the port's flat constraint solvers (mgf_tpu_torch.solver:
``build_constraints``, ``solve_sequential`` with kernel K4's plain version,
``solve_parallel``) and of ``solve_rows(friction_mode="mgf")`` with
mgf_tpu's, on random systems made with numpy and handed to both.

Tolerances and their reasons:

* ``build_constraints``: every float field within 1e-6 relative (and 1e-6
  absolute near 0); indices and masks exact.  Same formulas, same op order.
* the solves (64 bodies, 300 points, 20 sweeps, Mat3 inertia): v and omega
  within 2e-5.  The plain sequential version and XLA round each op once,
  but XLA may fuse a multiply-add or reorder a three-term dot; the parallel
  solver's segment sums run in another order than XLA's scatter.  Measured
  on the CPU: printed by the tests (-s).
* the plain sequential version over a list with invalid points interleaved
  equals the same solve over the valid points alone bit for bit (it visits
  the same points in the same order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mgf_tpu import solver as jsol  # noqa: E402
from mgf_tpu.manifold import Manifold as JManifold  # noqa: E402
from mgf_tpu.math3d import Mat3 as JMat3  # noqa: E402
from mgf_tpu.math3d import Vec3 as JVec3  # noqa: E402
from mgf_tpu.physics import SceneBuilder as JSceneBuilder  # noqa: E402

from mgf_tpu_torch import solver as tsol  # noqa: E402
from mgf_tpu_torch import world_from_numpy  # noqa: E402
from mgf_tpu_torch.collision import (  # noqa: E402
    LocalContact, contact_moving_moving, contact_sphere_moving_sphere,
)
from mgf_tpu_torch.geom import Sphere  # noqa: E402
from mgf_tpu_torch.manifold import Manifold as TManifold  # noqa: E402
from mgf_tpu_torch.manifold import prune  # noqa: E402
from mgf_tpu_torch.math3d import Mat3 as TMat3  # noqa: E402
from mgf_tpu_torch.math3d import Vec3 as TVec3  # noqa: E402
from mgf_tpu_torch.math3d import tree_map  # noqa: E402
from mgf_tpu_torch.ops import sequential_solve as tseq  # noqa: E402
from mgf_tpu_torch.physics import integrate  # noqa: E402

TOL_SOLVE = 2e-5


def _unit(a):
    return (a / np.linalg.norm(a, axis=0, keepdims=True)).astype(np.float32)


def _random_system(n=64, P=150, S=2, seed=0, valid_frac=0.7):
    """n bodies plus a static row (index n: zero inverse mass and inertia,
    zero velocity), P pairs with S contact slots each.  The bodies sit near
    the origin, so penetrations and biases are those of touching bodies
    (|v| and |omega| stay under ~20 through 20 sweeps)."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    m = n + 1
    nrm = _unit(f32(3, P))
    helper = np.broadcast_to(np.asarray([1.0, 0.1, -0.2], np.float32)[:, None],
                             nrm.shape)
    t1 = _unit(np.cross(nrm, helper, axis=0))
    t2 = np.cross(nrm, t1, axis=0).astype(np.float32)
    a = rng.integers(0, n, P)
    b = (a + rng.integers(1, n + 1, P)) % m          # != a; may be static
    # symmetric positive inverse inertia R diag R^T
    q = np.linalg.qr(rng.standard_normal((m, 3, 3)))[0]
    d = rng.uniform(0.5, 2.0, (m, 3))
    inertia = np.einsum("mij,mj,mkj->mik", q, d, q).astype(np.float32)
    body = dict(
        x=f32(3, m) * 0.05, v=f32(3, m), omega=f32(3, m) * 0.3,
        restitution=rng.uniform(0.1, 0.5, m).astype(np.float32),
        friction=rng.uniform(0.3, 0.8, m).astype(np.float32),
        inv_mass=rng.uniform(0.5, 1.5, m).astype(np.float32),
        inertia=inertia)
    for k in ("v", "omega", "x"):
        body[k][:, n] = 0.0
    body["inv_mass"][n] = 0.0
    body["inertia"][n] = 0.0
    body["restitution"][n] = 0.0
    body["friction"][n] = 0.0
    man = dict(time=rng.uniform(0, 1, P).astype(np.float32),
               normal=nrm, t1=t1, t2=t2,
               local_a=f32(3, S, P) * 0.4, local_b=f32(3, S, P) * 0.4,
               valid=rng.uniform(size=(S, P)) < valid_frac)
    return body, man, a.astype(np.int32), b.astype(np.int32)


def _side(body, man, a, b, arr, Vec, Mat, Man, BV):
    vec = lambda x: Vec(*(arr(np.ascontiguousarray(c)) for c in x))
    I = body["inertia"]
    bodies = BV(x=vec(body["x"]), v=vec(body["v"]), omega=vec(body["omega"]),
                restitution=arr(body["restitution"]),
                friction=arr(body["friction"]),
                inv_mass=arr(body["inv_mass"]),
                inv_moment=Mat(*(arr(np.ascontiguousarray(I[:, i, j]))
                                 for i in range(3) for j in range(3))))
    manifold = Man(time=arr(man["time"]), normal=vec(man["normal"]),
                   t1=vec(man["t1"]), t2=vec(man["t2"]),
                   local_a=vec(man["local_a"]), local_b=vec(man["local_b"]),
                   valid=arr(man["valid"]))
    return bodies, manifold, arr(a), arr(b)


def _np(x):
    if isinstance(x, tuple):
        return np.stack([_np(c) for c in x])
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _build(split, seed=0):
    body, man, a, b = _random_system(seed=seed)
    jb, jm, ja, jbb = _side(body, man, a, b, jnp.asarray, JVec3, JMat3,
                            JManifold, jsol.BodyView)
    tb, tm, ta, tbb = _side(body, man, a, b, torch.as_tensor, TVec3, TMat3,
                            TManifold, tsol.BodyView)
    js = ts = (None, None)
    if split:
        S = man["valid"].shape[0]
        m = body["inv_mass"].shape[0]
        va = np.tile(ja, S)
        vb = np.tile(jbb, S)
        cnt = np.asarray(jsol.contact_counts(jnp.asarray(man["valid"]
                                                         .reshape(-1)),
                                             jnp.asarray(va),
                                             jnp.asarray(vb), m))
        tcnt = tsol.contact_counts(torch.as_tensor(man["valid"].reshape(-1)),
                                   torch.as_tensor(va), torch.as_tensor(vb), m)
        np.testing.assert_array_equal(cnt, tcnt.numpy())
        js = (jnp.asarray(cnt[a]), jnp.asarray(cnt[b]))
        ts = (tcnt[torch.as_tensor(a).long()], tcnt[torch.as_tensor(b).long()])
    jcon = jsol.build_constraints(jb, ja, jbb, jm, 1.0 / 60.0, *js)
    tcon = tsol.build_constraints(tb, ta, tbb, tm, 1.0 / 60.0, *ts)
    return (jcon, jb), (tcon, tb), man


@pytest.mark.parametrize("split", [False, True])
def test_build_constraints_matches_jax(split):
    (jcon, _), (tcon, _), man = _build(split)
    C = man["valid"].size
    for f in jsol.ContactConstraints._fields:
        j, t = _np(getattr(jcon, f)), _np(getattr(tcon, f))
        assert t.shape[-1] == C
        if j.dtype.kind in "biu":
            np.testing.assert_array_equal(j, t, err_msg=f)
        else:
            np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6,
                                       err_msg=f)
    # slot-major: point s * P + p is pair p's slot s
    np.testing.assert_array_equal(_np(tcon.valid), man["valid"].reshape(-1))


@pytest.mark.parametrize("mode", ["textbook", "mgf"])
@pytest.mark.parametrize("solver", ["sequential", "parallel"])
def test_flat_solve_matches_jax(solver, mode):
    (jcon, jb), (tcon, tb), _ = _build(split=solver == "parallel", seed=1)
    jfn = getattr(jsol, f"solve_{solver}")
    tfn = getattr(tsol, f"solve_{solver}")
    vj, oj = jfn(jcon, jb, 20, mode)
    vt, ot = tfn(tcon, tb, 20, mode)
    err = max(np.abs(_np(vj) - _np(vt)).max(), np.abs(_np(oj) - _np(ot)).max())
    print(f"{solver} {mode}: max |dv|, |domega| vs JAX {err:.3g}")
    assert err <= TOL_SOLVE, err
    # the solve must do something, and the static row must not move
    assert np.abs(_np(vt) - _np(tb.v)).max() > 0.1
    assert np.abs(_np(vt)[:, -1]).max() == 0.0


def test_plain_sequential_skips_invalid_points_exactly():
    """Interleaving invalid points (with garbage fields) changes nothing:
    the plain version over the full list equals it over the valid points
    alone, bit for bit."""
    (_, _), (tcon, tb), _ = _build(split=False, seed=2)
    pts = tseq.pack_points(tcon)
    bodies = tseq.pack_bodies(tb.v, tb.omega, tb.inv_mass, tb.inv_moment)
    a, b, valid = tcon.body_a, tcon.body_b, tcon.valid
    assert 0 < int(valid.sum()) < valid.numel()
    keep = torch.nonzero(valid).flatten()
    for mgf in (False, True):
        full = tseq.sequential_solve(pts, a, b, valid, bodies, 20, mgf)
        only = tseq.sequential_solve(
            pts[keep].contiguous(), a[keep].contiguous(),
            b[keep].contiguous(), valid[keep].contiguous(), bodies, 20, mgf)
        assert torch.equal(full, only)
        garbage = pts.clone()
        garbage[~valid] = 1e30
        assert torch.equal(
            tseq.sequential_solve(garbage, a, b, valid, bodies, 20, mgf),
            full)
    with pytest.raises(TypeError):
        tseq.sequential_solve(pts, a.long(), b, valid, bodies, 20, False)


def _pair_constraints(sol_vel, mods):
    """tests/test_physics_solver.py's two-sphere state (r=1 at x=+-5,
    integrated with dt=1) on the port: the contact, its manifold and the
    flat constraints over one pair."""
    b = JSceneBuilder()
    for x in (-5.0, 5.0):
        b.add_sphere((x, 0.0, 0.0), 1.0, mass=1.0, restitution=0.3,
                     friction=0.5)
    state = b.build()
    vel = np.asarray(sol_vel, np.float32)
    state = state._replace(v=JVec3(*(jnp.asarray(vel[:, k])
                                     for k in range(3))))
    state = mods(state)
    state = world_from_numpy(jax.tree_util.tree_map(np.asarray, state),
                             "cpu")
    state = integrate(state, 1.0)
    sph = Sphere(c=state.x, r=state.shape_r)
    pick = lambda t, i: tree_map(lambda x: x[i], t)
    s_a, s_b = pick(sph, 0), pick(sph, 1)
    d_a, d_b = pick(state.delta, 0), pick(state.delta, 1)
    c = contact_moving_moving(contact_sphere_moving_sphere, s_a, d_a, s_b,
                              d_b)
    lc = LocalContact(local_a=c.a - (s_a.c + d_a * c.t),
                      local_b=c.b - (s_b.c + d_b * c.t), contact=c)
    # manifold_from_local_contact, lifted to a pair batch of one
    man = prune(tree_map(lambda x: x[None], lc), max_contacts=4)
    man = tree_map(lambda x: x[..., None], man)
    bodies = tsol.BodyView(x=state.x + state.delta, v=state.v,
                           omega=state.omega, restitution=state.restitution,
                           friction=state.friction, inv_mass=state.inv_mass,
                           inv_moment=state.inv_moment)
    con = tsol.build_constraints(bodies, torch.tensor([0]),
                                 torch.tensor([1]), man, 1.0)
    return c, con, bodies


def test_head_on_collision_golden():
    """tests/test_physics_solver.py::test_head_on_collision_golden on the
    port: bias 2.39, normal mass 0.5, converged v_x = -+1.195."""
    c, con, bodies = _pair_constraints([(4, 0, 0), (-4, 0, 0)],
                                       lambda s: s)
    assert bool(c.valid) and float(c.t) == pytest.approx(1.0)
    assert float(con.bias[0]) == pytest.approx(2.39, abs=1e-5)
    assert float(con.normal_mass[0]) == pytest.approx(0.5)
    v, omega = tsol.solve_sequential(con, bodies, 20)
    np.testing.assert_allclose(_np(v)[:, 0], [-1.195, -9.8, 0], atol=1e-4)
    np.testing.assert_allclose(_np(v)[:, 1], [1.195, -9.8, 0], atol=1e-4)
    np.testing.assert_allclose(_np(omega)[:, 0], 0.0, atol=1e-5)
    vp, _ = tsol.solve_parallel(con, bodies, 20)
    np.testing.assert_allclose(_np(vp), _np(v), atol=1e-5)


def test_static_body_rows_absorb_impulses():
    """tests/test_physics_solver.py::test_static_body_rows_absorb_impulses
    on the port: a zero-inverse-mass row never moves and the dynamic body
    bounces back at -2.39."""
    from mgf_tpu.math3d import mat_zero

    def static_b(s):
        return s._replace(inv_mass=jnp.asarray([1.0, 0.0]),
                          inv_moment=mat_zero((2,)),
                          inv_moment_body=mat_zero((2,)),
                          restitution=jnp.asarray([0.3, 0.0]),
                          force=JVec3(*(jnp.zeros((2,)),) * 3))

    c, con, bodies = _pair_constraints([(8, 0, 0), (0, 0, 0)], static_b)
    assert bool(c.valid)
    v, _ = tsol.solve_sequential(con, bodies, 20)
    np.testing.assert_allclose(_np(v)[:, 1], 0.0, atol=1e-6)
    np.testing.assert_allclose(_np(v)[:, 0], [-2.39, 0, 0], atol=1e-4)


@pytest.mark.parametrize("two_phase", [False, True])
def test_solve_rows_mgf_friction_matches_jax(two_phase):
    """solve_rows(friction_mode="mgf") (the raw-lambda friction) in the
    plain sweeps, scalar and Mat3 inertia, against mgf_tpu's."""
    from test_torch_solver import _assert_solve, _both, _random_rows
    rows, body = _random_rows(n=300, R=5, seed=7)
    (jrc, jb), (trc, tb) = _both(rows, body)
    for mat in (False, True):
        jI, tI = jb[3], tb[3]
        if mat:
            jz, tz = jnp.zeros_like(jI), torch.zeros_like(tI)
            jI = JMat3(jI, jz, jz, jz, jI, jz, jz, jz, jI * 0.5)
            tI = TMat3(tI, tz, tz, tz, tI, tz, tz, tz, tI * 0.5)
        run = lambda mod, rc, b, I: mod.solve_rows(
            rc, b[0], b[1], b[2], I, 3, friction_mode="mgf",
            two_phase=two_phase, inner_iters=2, return_acc=True)
        out_j = run(jsol, jrc, jb, jI)
        out_t = run(tsol, trc, tb, tI)
        _assert_solve(out_j, out_t, rows["valid"])
        textbook = tsol.solve_rows(trc, tb[0], tb[1], tb[2], tI, 3,
                                   two_phase=two_phase, inner_iters=2)
        assert np.abs(_np(textbook[0]) - _np(out_t[0])).max() > 1e-3
    with pytest.raises(ValueError):
        tsol.solve_rows(trc, tb[0], tb[1], tb[2], tb[3], 2,
                        friction_mode="mgf", two_phase=False,
                        pallas_inner=True)

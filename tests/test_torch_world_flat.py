"""The port's flat constraint branch (``solver="sequential"`` /
``"parallel"``: the reference's single-direction constraint list) against
mgf_tpu's, on the balls demo at 28 bodies (``balls_scene(3)``, all-pairs
candidates, the reference's raw-lambda friction), as
tests/test_oracle.py::test_sequential_trajectory_parity runs it.

A JAX state after the dropped ball strikes the block on the floor crosses
the numpy bridge and one port step is compared with one JAX step:

* the pair and terrain contact streams (indices, masks) and
  ``num_constraints`` / ``num_contacts`` exactly (integer work on identical
  inputs; the flat list's order is the JAX package's);
* v and omega within 1e-5 (measured on the CPU: 1.4e-6 sequential, 9.5e-7
  parallel; XLA may fuse or reorder a three-term dot).

The port then runs the JAX test's own trajectory gate against the f64
oracle (160 free-running steps, worst |dy| <= 5e-3), and a transposed flat
order (the pair block's (K, N) points taken column-major) must move the
sequential result by more than the tolerance: the test can see the order.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from mgf_tpu.scenes import balls_scene as j_balls_scene  # noqa: E402
from mgf_tpu.world import step as j_step  # noqa: E402

from mgf_tpu_torch import world as tworld  # noqa: E402
from mgf_tpu_torch import world_from_numpy, world_to_numpy  # noqa: E402
from mgf_tpu_torch.math3d import tree_map  # noqa: E402
from mgf_tpu_torch.scenes import balls_scene as t_balls_scene  # noqa: E402
from mgf_tpu_torch.world import WorldConfig, step  # noqa: E402

CPU = "cpu"
TOL_V = 1e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfg(solver):
    _, cfg = j_balls_scene(num=3, with_dropped=True)
    return cfg._replace(solver=solver, friction_mode="mgf", use_grid=False)


@pytest.fixture(scope="module")
def landing():
    """The 28-ball demo after 328 steps (the parallel flat solver, cheap to
    run in XLA): the block lies on the floor and the dropped ball has struck
    it, so bodies hold several pair contacts and the Gauss-Seidel order
    matters (the demo is symmetric: at some nearby steps a 1-ulp near-tie
    orders a body's partners or a diagonal floor contact differently in the
    two packages, so the step is chosen where the streams agree); then one step of each flat solver in mgf_tpu from there."""
    w, _ = j_balls_scene(num=3, with_dropped=True)
    f = jax.jit(functools.partial(j_step, cfg=_cfg("parallel")))
    for _ in range(328):
        w, _ = f(w)
    out = {"state": w}
    for solver in ("sequential", "parallel"):
        g = jax.jit(functools.partial(j_step, cfg=_cfg(solver),
                                      collect_contacts=True))
        out[solver] = _np_tree(g(w))
    return out


def _port_step(state, solver):
    w = world_from_numpy(_np_tree(state), CPU)
    return step(w, WorldConfig(*_cfg(solver)), collect_contacts=True)


def _max_vel_err(jw, tw):
    return max(float(np.abs(np.asarray(a) - b.numpy()).max())
               for f in ("v", "omega")
               for a, b in zip(getattr(jw.bodies, f), getattr(tw.bodies, f)))


@pytest.mark.parametrize("solver", ["sequential", "parallel"])
def test_flat_step_matches_jax(landing, solver):
    jw, jm = landing[solver]
    tw, tm = _port_step(landing["state"], solver)
    tm = world_to_numpy(tm)
    assert int(jm["num_contacts"]) > 10           # the landing is on
    for key in ("num_contacts", "num_constraints", "num_pairs",
                "solver_rows_dropped", "broadphase_overflow"):
        assert int(np.asarray(jm[key])) == int(tm[key]), key
    # 28 bodies x (16 pair slots + 10 terrain faces), one contact slot each
    assert int(tm["num_constraints"]) == 28 * (16 + 10)
    for kind, other in (("pair_contacts", "j"), ("terrain_contacts", "tri")):
        js, ts = jm[kind], tm[kind]
        np.testing.assert_array_equal(np.asarray(js["i"]), ts["i"])
        np.testing.assert_array_equal(np.asarray(js[other]), ts[other])
        np.testing.assert_array_equal(np.asarray(js["contact"].valid),
                                      ts["contact"].valid)
    err = _max_vel_err(jw, tw)
    print(f"{solver}: max |dv|, |domega| vs JAX {err:.3g}")
    assert err <= TOL_V, err
    # the solve moved the landing bodies
    assert np.abs(tw.bodies.v.y.numpy()
                  - np.asarray(landing["state"].bodies.v.y)).max() > 0.1


def test_capture_inputs_records_the_sequential_solve(landing):
    """ops.sequential_solve.capture_inputs, which gives the K4 tests and
    chip_smoke.py their inputs, records the step's one solve (the flat
    list of 28 x 26 points, the 29 body rows, the config's sweeps and
    friction), leaves the step's result as it was, and restores the
    wrapper."""
    from mgf_tpu_torch.ops import sequential_solve as seq
    solve = seq.sequential_solve
    w = world_from_numpy(_np_tree(landing["state"]), CPU)
    cfg = WorldConfig(*_cfg("sequential"))
    rec, (tw, tm) = seq.capture_inputs(lambda: step(w, cfg))
    assert seq.sequential_solve is solve
    ref, _ = step(w, cfg)
    for f in ("v", "omega"):
        for a, b in zip(getattr(tw.bodies, f), getattr(ref.bodies, f)):
            assert torch.equal(a, b), f
    assert rec["iters"] == cfg.solver_iters and rec["mgf"] is True
    assert rec["pts"].shape == (int(tm["num_constraints"]), 20)
    assert rec["bodies"].shape == (29, 16)
    assert int(rec["valid"].sum()) == int(tm["num_contacts"]) > 10


def test_transposed_flat_order_is_seen(landing, monkeypatch):
    """The port keeps pair batches (K, N) where mgf_tpu flattens them to
    (K * N,): a column-major flattening solves the same points in another
    Gauss-Seidel order.  That must move the sequential result by more than
    the tolerance above (and the parallel one not at all beyond it)."""
    orig = tworld._flat_solve

    def transposed(cfg, manifolds, idx_a, idx_b, bodies_ext, n):
        pair = manifolds[0]
        K = pair.valid.shape[-2]
        pair = tree_map(lambda x: x.transpose(-1, -2).contiguous(), pair)
        col = lambda i: i.reshape(K, n).T.reshape(-1)
        return orig(cfg, [pair] + manifolds[1:], [col(idx_a[0])] + idx_a[1:],
                    [col(idx_b[0])] + idx_b[1:], bodies_ext, n)

    monkeypatch.setattr(tworld, "_flat_solve", transposed)
    errs = {}
    for solver in ("sequential", "parallel"):
        tw, _ = _port_step(landing["state"], solver)
        errs[solver] = _max_vel_err(landing[solver][0], tw)
    print(f"column-major flat order: max |dv|, |domega| vs JAX {errs}")
    assert errs["sequential"] > 10 * TOL_V, errs
    assert errs["parallel"] <= TOL_V, errs


def test_sequential_trajectory_parity():
    """tests/test_oracle.py::test_sequential_trajectory_parity on the port:
    the free-running f32 sequential Gauss-Seidel step (kernel K4's plain
    version on the CPU) against the f64 oracle through the landing."""
    from mgf_tpu import oracle

    jworld, cfg = j_balls_scene(num=3, with_dropped=True)   # 28 bodies
    cfg = cfg._replace(solver="sequential", friction_mode="mgf",
                       use_grid=False)
    world, tcfg = t_balls_scene(num=3, with_dropped=True, device=CPU)
    assert tcfg == WorldConfig(*j_balls_scene(3)[1])
    tcfg = WorldConfig(*cfg)
    ow = oracle.from_world(jworld)
    worst_dx, contacts = 0.0, 0
    for _ in range(160):
        world, m = step(world, tcfg)
        ow, _ = oracle.oracle_step(ow, dt=cfg.dt, iters=cfg.solver_iters,
                                   mgf_friction=True)
        worst_dx = max(worst_dx, float(np.abs(world.bodies.x.y.numpy()
                                              - ow.x[:, 1]).max()))
        contacts = max(contacts, int(m["num_contacts"]))
    print(f"160 steps: worst |dy| vs the f64 oracle {worst_dx:.3g}, "
          f"most contacts in a step {contacts}")
    assert contacts > 10                      # the landing is in the run
    # measured r2 on mgf_tpu: ~1.5e-4 at impact, ~6e-5 settled
    assert worst_dx <= 5e-3, worst_dx

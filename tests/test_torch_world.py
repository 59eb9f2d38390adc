"""The port's flagship step (mgf_tpu_torch.world/scenes/driver) against
mgf_tpu's, and the port-side twins of tests/test_step_features.py.

A small stress pile (800 bodies, 12 layers) is stepped by mgf_tpu under
jit (its solver kernel in Pallas interpret mode); its numpy state crosses
the bridge, and one port step is compared with one JAX step on the same
state.  Tolerances and their reasons:

* index streams, validity masks and the broadphase cache: exact (integer
  work on identical inputs);
* contact normals: atol 1e-4, and contact times within 1e-4 where the
  body approaches the contact plane faster than 0.01 per step; slower
  approaches are held to 1e-6 of travel along the normal instead, since
  t = (r - dist) / (n . v) divides float32 rounding noise in dist by a
  tiny n . v (XLA's fused jit differs from its own eager ops there too);
* v and omega after the solve: atol 2e-4 (row sums in another order than
  XLA's fused reductions, compounded over 16 sweeps, as
  test_solver_sweep.py).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from mgf_tpu.scenes import stress_scene as j_stress_scene  # noqa: E402
from mgf_tpu.world import step as j_step  # noqa: E402

from mgf_tpu_torch import world_from_numpy, world_to_numpy  # noqa: E402
from mgf_tpu_torch.broadphase import GridConfig  # noqa: E402
from mgf_tpu_torch.driver import (  # noqa: E402
    AdaptiveChunkStepper, make_chunk_step,
)
from mgf_tpu_torch.physics import SceneBuilder  # noqa: E402
from mgf_tpu_torch.scenes import stress_scene as t_stress_scene  # noqa: E402
from mgf_tpu_torch.world import (  # noqa: E402
    WorldConfig, init_bp_cache, init_warm, make_world, step,
)

N_BODIES = 800
CPU = "cpu"


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_run():
    """mgf_tpu's pile: the state after 120 steps (mid-settle) and after
    260 steps (settled), plus the jitted step (the states stay JAX arrays:
    a numpy round trip would change their weak types and recompile)."""
    world, cfg = j_stress_scene(N_BODIES)
    f = jax.jit(functools.partial(j_step, cfg=cfg))
    states = {}
    for k in range(1, 261):
        world, m = f(world)
        if k in (120, 260):
            states[k] = world
    m = _np_tree(m)
    assert int(m["broadphase_overflow"]) == 0
    assert float(m["max_penetration"]) < 0.3
    return states, cfg, f


def _pos(world):
    return np.stack([c.numpy() for c in world.bodies.x], -1)


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


@pytest.mark.parametrize("n,layers", [(N_BODIES, 12), (1000, 5)])
def test_stress_scene_matches_jax(n, layers):
    jw, jcfg = j_stress_scene(n, layers=layers)
    tw, tcfg = t_stress_scene(n, layers=layers, device=CPU)
    a, b = _leaves(_np_tree(jw)), _leaves(world_to_numpy(tw))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
    assert tuple(jcfg) == tuple(tcfg)
    assert jcfg._fields == tcfg._fields


def _approach(delta_a, delta_b, n):
    """|n . (per-step displacement of b relative to a)|."""
    rel = [db - da for da, db in zip(delta_a, delta_b)]
    return np.abs(sum(r * c for r, c in zip(rel, n)))


def _assert_stream(js, ts, approach):
    for k in js:
        if k != "contact":
            np.testing.assert_array_equal(js[k], ts[k], err_msg=k)
    jc, tc = js["contact"], ts["contact"]
    np.testing.assert_array_equal(jc.valid, tc.valid)
    v = jc.valid
    assert v.sum() > 100
    for a, b in zip(jc.n, tc.n):
        np.testing.assert_allclose(a[v], b[v], atol=1e-4, rtol=0)
    dt = np.abs(jc.t[v] - tc.t[v])
    s = approach[v]
    fast = s >= 1e-2
    assert (dt[fast] <= 1e-4).all(), dt[fast].max()
    assert (dt[~fast] * s[~fast] <= 1e-6).all()


def _assert_one_step_matches_jax(jw, cfg):
    fc = jax.jit(functools.partial(j_step, cfg=cfg, collect_contacts=True))
    jw2, jm = fc(jw)
    jm, jw2 = _np_tree(jm), _np_tree(jw2)
    tcfg = WorldConfig(*cfg)
    tw2, tm = step(world_from_numpy(_np_tree(jw), CPU), tcfg,
                   collect_contacts=True)
    tm, tw2n = world_to_numpy(tm), world_to_numpy(tw2)

    # this frame's sweep (delta keeps its pre-solve value after the step)
    d = [np.asarray(c) for c in tw2n.bodies.delta]
    pc = jm["pair_contacts"]
    i, j = pc["i"], pc["j"]
    n_pair = [np.asarray(c).ravel() for c in pc["contact"].n]
    pair_app = _approach([c[i] for c in d], [c[j] for c in d],
                         n_pair).reshape(pc["contact"].t.shape)
    _assert_stream(pc, tm["pair_contacts"], pair_app)
    tcn = jm["terrain_contacts"]
    n_ter = [np.asarray(c).ravel() for c in tcn["contact"].n]
    z = np.zeros_like(tcn["i"], np.float32)
    ter_app = _approach([c[tcn["i"]] for c in d], [z, z, z],
                        n_ter).reshape(tcn["contact"].t.shape)
    _assert_stream(tcn, tm["terrain_contacts"], ter_app)

    for k in ("broadphase_overflow", "broadphase_rebuilt", "num_contacts",
              "num_pairs", "num_constraints"):
        assert int(jm[k]) == int(tm[k]), k
    for k in ("warm_hit_frac", "max_penetration",
              "broadphase_cache_drift_excess"):
        np.testing.assert_allclose(jm[k], tm[k], atol=1e-5, err_msg=k)
    for f in ("v", "omega"):
        for a, b in zip(getattr(jw2.bodies, f), getattr(tw2n.bodies, f)):
            np.testing.assert_allclose(a, b, atol=2e-4, rtol=0, err_msg=f)
    for f in ("x", "q", "delta"):
        for a, b in zip(getattr(jw2.bodies, f), getattr(tw2n.bodies, f)):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0, err_msg=f)
    # the carried state: broadphase cache exactly, warm rows exactly,
    # accumulators on live rows at the solver tolerance
    assert (jw2.bp is None) == (tw2n.bp is None)
    for a, b in zip(_leaves(jw2.bp), _leaves(tw2n.bp)):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(jw2.warm.partner, tw2n.warm.partner)
    np.testing.assert_array_equal(jw2.warm.key2, tw2n.warm.key2)
    live = jw2.warm.partner != -9
    for f in ("acc_n", "acc_t1", "acc_t2"):
        np.testing.assert_allclose(getattr(jw2.warm, f)[live],
                                   getattr(tw2n.warm, f)[live], atol=2e-4,
                                   rtol=1e-4, err_msg=f)


def test_one_step_matches_jax(jax_run):
    states, cfg, _ = jax_run
    _assert_one_step_matches_jax(states[120], cfg)


def test_one_step_uncached_fat_grid_matches_jax(jax_run):
    """bp_every=1 and no cache state on the fused branch: the fat grid is
    built afresh from this step's bounds (mgf_tpu/world.py:828-831), at
    the tolerances above."""
    states, cfg, _ = jax_run
    _assert_one_step_matches_jax(states[120]._replace(bp=None),
                                 cfg._replace(bp_every=1))

def test_sixteen_steps_guards_match_jax(jax_run):
    states, cfg, f = jax_run
    jw = states[120]
    tw = world_from_numpy(_np_tree(jw), CPU)
    tcfg = WorldConfig(*cfg)
    for _ in range(16):
        jw, jm = f(jw)
        tw, tm = step(tw, tcfg)
        jm, tm = _np_tree(jm), world_to_numpy(tm)
        nj, nt = int(jm["num_contacts"]), int(tm["num_contacts"])
        assert abs(nj - nt) <= 0.01 * nj, (nj, nt)
        assert abs(float(jm["max_penetration"])
                   - float(tm["max_penetration"])) <= 0.01
        assert abs(float(jm["warm_hit_frac"])
                   - float(tm["warm_hit_frac"])) <= 0.02
        for m in (jm, tm):
            assert int(m["broadphase_overflow"]) == 0
            assert float(m["broadphase_cache_drift_excess"]) == 0.0


def _stack_world(cfg):
    b = SceneBuilder()
    b.add_sphere((0.0, 0.5, 0.0), 0.5, 1.0, 0.0, 0.6)
    b.add_sphere((0.0, 1.5, 0.0), 0.5, 1.0, 0.0, 0.6)
    b.add_sphere((1.1, 0.5, 0.0), 0.5, 1.0, 0.0, 0.6)
    verts = np.asarray([[-5, 0, -5], [-5, 0, 5], [5, 0, 5], [5, 0, -5]],
                       np.float32)
    faces = np.asarray([(0, 1, 3), (1, 2, 3)], np.int32)
    world = make_world(b.build(CPU), verts, faces, device=CPU)
    return init_bp_cache(init_warm(world, cfg, CPU), cfg, CPU)


def _steps(world, cfg, n, collect=()):
    ms = []
    for _ in range(n):
        world, m = step(world, cfg)
        ms.append({k: float(m[k]) for k in collect})
    return world, ms


def test_warm_match_hybrid_equals_search_across_cadence():
    """hybrid == search EXACTLY across a window with both rebuild steps
    (keyed search) and reuse steps (positional match) — the port's host
    branch on `need` replaces the JAX lax.cond (test_step_features.py
    twin, on the fused flagship branch)."""
    base = WorldConfig(dt=1 / 60, solver_iters=4, solver_inner=2,
                       two_phase=False, shape_mode="spheres", solver="rows",
                       grid=GridConfig(cell_size=2.0, dim=8, bucket_cap=4),
                       max_pairs=4, fatten=0.02, warm_start=True,
                       stable_pairs=True, terrain_bp="near", terrain_cand=2,
                       bp_every=2, broadphase="fat27x4", fused_iso=True,
                       pallas_solver=True)
    w0, _ = _steps(_stack_world(base), base, 30)
    out = {}
    for mode in ("search", "hybrid"):
        out[mode] = _steps(w0, base._replace(warm_match=mode), 8,
                           collect=("warm_hit_frac", "broadphase_rebuilt"))
    (w_h, ms_h), (w_s, ms_s) = out["hybrid"], out["search"]
    rebuilt = [bool(m["broadphase_rebuilt"]) for m in ms_h]
    assert any(rebuilt) and not all(rebuilt), rebuilt
    np.testing.assert_array_equal(_pos(w_h), _pos(w_s))
    for mh, msr in zip(ms_h, ms_s):
        assert mh["warm_hit_frac"] == msr["warm_hit_frac"] == 1.0


@pytest.fixture(scope="module")
def settled(jax_run):
    states, cfg, _ = jax_run
    return world_from_numpy(_np_tree(states[260]), CPU), WorldConfig(*cfg)


def test_chunk_step_matches_per_step(settled):
    """make_chunk_step is the SAME physics as C separate step() calls:
    bit-equal positions and per-step metrics."""
    world, cfg = settled
    cfg1 = cfg._replace(adapt_schedule=None)
    C = 6
    w_c, ms = make_chunk_step(cfg1)(world, torch.ones(C))
    w_s, per_step = world, []
    for _ in range(C):
        w_s, m = step(w_s, cfg1)
        per_step.append(int(m["num_contacts"]))
    np.testing.assert_array_equal(_pos(w_c), _pos(w_s))
    np.testing.assert_array_equal(ms["num_contacts"].numpy(), per_step)
    assert float(ms["max_penetration"][-1]) == float(m["max_penetration"])
    # light chunks: same physics, interior metrics zeroed, last step full
    w_l, ml = make_chunk_step(cfg1, light=True)(world, torch.ones(C))
    np.testing.assert_array_equal(_pos(w_l), _pos(w_s))
    assert int(ml["num_contacts"][0]) == 0
    assert int(ml["num_contacts"][-1]) == per_step[-1]


def test_adaptive_chunk_stepper_schedules(settled):
    """AdaptiveChunkStepper engages the cheap schedule only after
    ``patience`` lagged reads at/above the threshold, and its hot chunks
    equal the explicit static cheap schedule."""
    world, cfg = settled
    thr, it2, in2 = cfg.adapt_schedule
    C = 3
    st = AdaptiveChunkStepper(cfg, chunk=C, patience=2)
    w, hots = world, []
    for _ in range(5):
        w, _ = st.step_chunk(w)
        hots.append(st.hot_on)
    assert hots[0] is False
    assert st.hot_on, hots
    cheap = make_chunk_step(cfg._replace(adapt_schedule=None,
                                         solver_iters=int(it2),
                                         solver_inner=int(in2)))
    w1, _ = st.hot(w, torch.ones(C))
    w2, _ = cheap(w, torch.ones(C))
    np.testing.assert_array_equal(_pos(w1), _pos(w2))
    st._pending.insert(0, torch.tensor(0.0))
    st._drain_one()
    assert st.hot_on is False


@pytest.mark.parametrize("n_fast", [1, 48])
def test_fast_movers_force_rebuild(settled, n_fast):
    """The staleness gate: bodies that outrun their build slack (60 m/s,
    1.0 per step) force a rebuild the same step, so reuse steps never
    carry drift excess (test_step_features.py fast-mover and transient
    twins)."""
    world, cfg = settled
    b = world.bodies
    vx = b.v.x.clone()
    vx[:n_fast] = 60.0
    fast = world._replace(bodies=b._replace(v=b.v._replace(x=vx)))
    _, ms = _steps(fast, cfg, 4, collect=("broadphase_rebuilt",
                                          "broadphase_cache_drift_excess"))
    assert all(m["broadphase_rebuilt"] for m in ms)
    assert all(m["broadphase_cache_drift_excess"] == 0.0 for m in ms)


def test_cadence_engages_on_settled_pile(settled):
    """On the settled pile the flagship cadence reuses the cached list:
    fewer rebuilds than steps, zero drift excess."""
    world, cfg = settled
    _, ms = _steps(world, cfg, 12, collect=("broadphase_rebuilt",
                                            "broadphase_cache_drift_excess"))
    assert sum(m["broadphase_rebuilt"] for m in ms) < 6
    assert max(m["broadphase_cache_drift_excess"] for m in ms) == 0.0


def test_step_honours_adapt_schedule(settled):
    """A direct step() reads warm_hit_frac on the host and picks the
    schedule (the JAX lax.cond at world.py:1507)."""
    world, cfg = settled
    w_a, m = step(world, cfg)
    thr, it2, in2 = cfg.adapt_schedule
    hot = float(m["warm_hit_frac"]) >= thr
    it, inner = (it2, in2) if hot else (cfg.solver_iters, cfg.solver_inner)
    w_e, _ = step(world, cfg._replace(adapt_schedule=None, solver_iters=it,
                                      solver_inner=inner))
    np.testing.assert_array_equal(_pos(w_a), _pos(w_e))
    np.testing.assert_array_equal(w_a.bodies.v.x.numpy(),
                                  w_e.bodies.v.x.numpy())
    w_n, _ = step(world, cfg._replace(adapt_schedule=(1.1, it2, in2)))
    w_f, _ = step(world, cfg._replace(adapt_schedule=None))
    np.testing.assert_array_equal(w_n.bodies.v.x.numpy(),
                                  w_f.bodies.v.x.numpy())


def test_bp_every_trajectory_parity_settled(settled):
    """Port twin of tests/test_step_features.py's test of the same name: on
    the settled pile the cached candidate list (bp_every=2) is a superset
    of the fresh one (bp_every=1, the uncached fat-grid build, no cache
    state) whose extras are out of contact range, so trajectories track
    to the same two-tier noise band as the JAX package's (candidate slot
    membership differs between cached and fresh lists, so row order and
    f32 rounding differ)."""
    world, cfg = settled
    cfg2 = cfg._replace(bp_every=2)
    w2, ms2 = _steps(world, cfg2, 24, collect=("broadphase_rebuilt",))
    w1, ms1 = _steps(world._replace(bp=None), cfg._replace(bp_every=1), 24,
                     collect=("broadphase_rebuilt",
                              "broadphase_cache_drift_excess"))
    assert w1.bp is None
    assert all(m["broadphase_rebuilt"] for m in ms1)
    assert all(m["broadphase_cache_drift_excess"] == 0.0 for m in ms1)
    d = np.abs(_pos(w2) - _pos(w1))
    assert d.max() < 0.02, d.max()
    assert (d > 5e-3).mean() < 0.01, (d > 5e-3).mean()
    assert np.median(d) < 1e-3, np.median(d)
    rebuilt = [bool(m["broadphase_rebuilt"]) for m in ms2]
    assert 12 <= sum(rebuilt) <= 18, rebuilt


def _pair_stream(m):
    pc = m["pair_contacts"]
    return pc["i"], pc["j"], pc["contact"].valid


def test_off_slice_configs_raise(jax_run, settled):
    """The configurations the port once refused (the stage probes, the
    octant broadphase, the refit cache) run on the settled pile, finite,
    with mgf_tpu's pair stream (from a JAX step cut to one sweep: the
    stream is fixed before the solver runs) and probe; the JAX package's
    own guards still raise."""
    states, jcfg, _ = jax_run
    world, cfg = settled
    cut = dict(pallas_solver=False, solver_iters=1, solver_inner=1,
               adapt_schedule=None)
    jp = jax.jit(functools.partial(j_step, cfg=jcfg._replace(
        profile_stage="pairs", **cut)))(states[260])[1]["probe"]
    w_p, m_p = step(world, cfg._replace(profile_stage="pairs"))
    assert w_p is world and int(m_p["probe"]) == int(jp)
    for over in (dict(broadphase="fat8x4"), dict(bp_margin=0.5)):
        w2, m = step(world, cfg._replace(adapt_schedule=None, **over),
                     collect_contacts=True)
        assert all(bool(torch.isfinite(c).all())
                   for c in (*w2.bodies.x, *w2.bodies.v, *w2.bodies.omega))
        jm = jax.jit(functools.partial(
            j_step, cfg=jcfg._replace(**cut, **over),
            collect_contacts=True))(states[260])[1]
        for a, b in zip(_pair_stream(_np_tree(jm)),
                        _pair_stream(world_to_numpy(m))):
            np.testing.assert_array_equal(a, b)
        assert bool(m["broadphase_rebuilt"]) == bool(
            jm["broadphase_rebuilt"])
    # the JAX package's own guards: the fused branch is for spheres and the
    # rows solver, the hybrid match needs canonical slots, and the "grid"
    # terrain cull needs the world's face table (the flat solvers and the
    # face grid run since the reference-solver and mesh slices)
    for bad in (cfg._replace(shape_mode="mixed"),
                cfg._replace(stable_pairs=False),
                cfg._replace(solver="parallel"),
                cfg._replace(terrain_bp="grid")):
        with pytest.raises(ValueError):
            step(world, bad)
    # warm starting off the fused branch and the mixed pile run since the
    # capsule slice
    w2, m = step(world, cfg._replace(fused_iso=False, pallas_solver=False))
    assert float(m["warm_hit_frac"]) > 0.9
    w_mixed, cfg_mixed = t_stress_scene(100, mixed=True, device=CPU)
    assert cfg_mixed.shape_mode == "mixed" and not cfg_mixed.fused_iso

"""The port's mixed sphere/capsule step (``stress_scene(mixed=True)``: the
type-partitioned narrowphase, the two-block solve, the hybrid warm match at
24 rows, ``warm_gamma``, ``cap_manifold="ends"``) against mgf_tpu's.

An 800-body mixed pile (600 spheres, then 200 capsules) is stepped by
mgf_tpu under jit; from step 100 on, the first state whose next step
rebuilds the broadphase cache and the first whose next step reuses it are
kept.  Each crosses the numpy bridge, and one port step is compared with
the JAX step from the same state.  Tolerances and their reasons:

* partner and triangle index streams, validity masks, the warm rows'
  (partner, key2) keys, the broadphase cache's indices and every integer
  metric: exact (integer work on identical inputs);
* contact normals atol 1e-4, witnesses atol 1e-3, contact times as
  tests/test_torch_world.py holds them (an absolute bound where the body
  approaches the contact plane faster than 0.01 per step, else 1e-6 of
  travel along the normal), the absolute bound being 2e-4 here: a sphere
  that rolls over the floor's diagonal edge meets it in a grazing sweep,
  whose quadratic has a discriminant near zero (measured 1.1e-4 on one
  such lane, 4.4e-6 on the pair stream);
* v after the solve atol 2e-4; omega and the warm accumulators atol 2e-4
  plus rtol 1e-4 (16 sweeps in two chained blocks, each summing up to 24
  rows in another order than XLA's fused reductions; a capsule's inverse
  inertia, ~7 per unit mass times its contact count, multiplies that noise
  into omega);
* inside the port, the type-partitioned contact routines against the
  unpartitioned ones: bit for bit.

The port twins of tests/test_world.py::test_mixed_mini_steps and
tests/test_step_features.py::test_warm_gamma_semantics run the port alone;
test_mixed_reference_meets_smoke_guard runs both packages free for 128
steps at 2,000 bodies and holds each to chip_smoke.py's guards.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from mgf_tpu.scenes import stress_scene as j_stress_scene  # noqa: E402
from mgf_tpu.world import step as j_step  # noqa: E402

from mgf_tpu_torch import world as tworld  # noqa: E402
from mgf_tpu_torch import world_from_numpy, world_to_numpy  # noqa: E402
from mgf_tpu_torch.broadphase import GridConfig  # noqa: E402
from mgf_tpu_torch.driver import AdaptiveChunkStepper  # noqa: E402
from mgf_tpu_torch.geom import Triangle  # noqa: E402
from mgf_tpu_torch.math3d import tree_map  # noqa: E402
from mgf_tpu_torch.physics import (  # noqa: E402
    SceneBuilder, complete_motion, integrate,
)
from mgf_tpu_torch.scenes import stress_scene as t_stress_scene  # noqa: E402
from mgf_tpu_torch.world import (  # noqa: E402
    WorldConfig, init_bp_cache, init_warm, make_world, solver_row_count,
    step,
)

CPU = "cpu"
N_BODIES = 800


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_mixed():
    """{"rebuild" | "reuse": (state before the step, JAX state after it,
    JAX metrics with the contact streams)} as numpy trees, and the config.
    One jitted function serves the run-up and the compared steps."""
    world, cfg = j_stress_scene(N_BODIES, mixed=True)
    f = jax.jit(functools.partial(j_step, cfg=cfg, collect_contacts=True))
    out = {}
    for k in range(260):
        w2, m = f(world)
        if k >= 100:
            kind = "rebuild" if bool(m["broadphase_rebuilt"]) else "reuse"
            if kind not in out:
                out[kind] = (_np_tree(world), _np_tree(w2), _np_tree(m))
            if len(out) == 2:
                break
        world = w2
    assert set(out) == {"rebuild", "reuse"}
    return out, cfg


# the port's mixed pile differs from mgf_tpu's in these settings alone
# (its cell table, pair rows, terrain candidates, sweep schedule and warm
# start, set for the settled 100k pile: mgf_tpu_torch/scenes.py, PERF.md)
PORT_MIXED = dict(grid=GridConfig(cell_size=2.0, dim=(128, 16, 128),
                                  bucket_cap=24),
                  max_pairs=12, terrain_cand=6, adapt_schedule=(0.97, 4, 4),
                  warm_gamma=0.6)


@pytest.mark.parametrize("n,cap_frac", [(N_BODIES, 0.25), (300, 0.5),
                                        (64, 1.0)])
def test_mixed_scene_matches_jax(n, cap_frac):
    jw, jcfg = j_stress_scene(n, mixed=True, cap_frac=cap_frac)
    tw, tcfg = t_stress_scene(n, mixed=True, cap_frac=cap_frac, device=CPU)
    # the same scene, and with mgf_tpu's settings the same warm-start and
    # broadphase-cache state: both built from one config on each side
    jcfg_t = WorldConfig(*jcfg)
    tw = init_bp_cache(init_warm(tw, jcfg_t), jcfg_t)
    a = jax.tree_util.tree_leaves(_np_tree(jw))
    b = jax.tree_util.tree_leaves(world_to_numpy(tw))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
    assert {k for k in WorldConfig._fields
            if getattr(jcfg, k) != getattr(tcfg, k)} == set(PORT_MIXED)
    assert tuple(jcfg_t._replace(**PORT_MIXED)) == tuple(tcfg)
    n_caps = int(tw.bodies.shape_type.sum())
    assert tcfg.n_sphere_rows == n - n_caps
    # type-sorted: the spheres first
    assert not tw.bodies.shape_type[:tcfg.n_sphere_rows].any()
    assert tw.warm.partner.shape == (solver_row_count(jcfg_t, 10), n) == \
        (24, n)
    assert solver_row_count(tcfg, 10) == 36


@pytest.mark.parametrize("cap_frac", [0.0, -0.5, float("nan")])
def test_cap_frac_must_be_positive(cap_frac):
    with pytest.raises(ValueError, match="cap_frac"):
        t_stress_scene(64, mixed=True, cap_frac=cap_frac, device=CPU)


def _approach(delta_a, delta_b, n):
    rel = [db - da for da, db in zip(delta_a, delta_b)]
    return np.abs(sum(r * c for r, c in zip(rel, n)))


def _assert_stream(js, ts, approach, min_valid):
    for k in js:
        if k != "contact":
            np.testing.assert_array_equal(js[k], ts[k], err_msg=k)
            assert js[k].dtype == ts[k].dtype, k
    jc, tc = js["contact"], ts["contact"]
    np.testing.assert_array_equal(jc.valid, tc.valid)
    v = jc.valid
    assert v.shape[0] == 2
    assert v.sum() >= min_valid, v.sum()
    for a, b in zip(jc.n, tc.n):
        np.testing.assert_allclose(a[v], b[v], atol=1e-4, rtol=0)
    for pj, pt in ((jc.a, tc.a), (jc.b, tc.b)):
        for a, b in zip(pj, pt):
            np.testing.assert_allclose(a[v], b[v], atol=1e-3, rtol=0)
    dt = np.abs(jc.t[v] - tc.t[v])
    s = np.broadcast_to(approach, v.shape)[v]
    fast = s >= 1e-2
    assert (dt[fast] <= 2e-4).all(), dt[fast].max()
    assert (dt[~fast] * s[~fast] <= 1e-6).all()


@pytest.mark.parametrize("kind", ["rebuild", "reuse"])
def test_mixed_one_step_matches_jax(jax_mixed, kind):
    states, cfg = jax_mixed
    w0, jw2, jm = states[kind]
    tcfg = WorldConfig(*cfg)
    tw2, tm = step(world_from_numpy(w0, CPU), tcfg, collect_contacts=True)
    tm, tw2 = world_to_numpy(tm), world_to_numpy(tw2)
    assert bool(tm["broadphase_rebuilt"]) == (kind == "rebuild")

    d = [np.asarray(c) for c in tw2.bodies.delta]
    pc = jm["pair_contacts"]
    # slot 0 holds every class; slot 1 only capsule-capsule flank ends
    ns = cfg.n_sphere_rows
    cc = (pc["i"] >= ns) & (pc["j"] >= ns)
    assert not pc["contact"].valid[1][~cc].any()
    app = _approach([c[pc["i"]] for c in d], [c[pc["j"]] for c in d],
                    [np.asarray(c) for c in pc["contact"].n])
    _assert_stream(pc, tm["pair_contacts"], app, 1500)
    tcn = jm["terrain_contacts"]
    z = np.zeros_like(tcn["i"], np.float32)
    app = _approach([c[tcn["i"]] for c in d], [z, z, z],
                    [np.asarray(c) for c in tcn["contact"].n])
    _assert_stream(tcn, tm["terrain_contacts"], app, 100)
    # a capsule lying on the floor holds both terrain slots
    assert tcn["contact"].valid[1].sum() > 0

    for k in ("broadphase_overflow", "broadphase_rebuilt", "num_contacts",
              "num_pairs", "num_constraints", "num_alive",
              "solver_rows_dropped"):
        assert int(jm[k]) == int(tm[k]), k
    for k in ("max_penetration", "broadphase_reach_excess",
              "broadphase_span_excess", "broadphase_cache_drift_excess",
              "warm_hit_frac"):
        np.testing.assert_allclose(jm[k], tm[k], atol=1e-5, err_msg=k)
    assert float(tm["warm_hit_frac"]) > 0.5

    for a, b in zip(jw2.bodies.v, tw2.bodies.v):
        np.testing.assert_allclose(a, b, atol=2e-4, rtol=0)
    for a, b in zip(jw2.bodies.omega, tw2.bodies.omega):
        np.testing.assert_allclose(a, b, atol=2e-4, rtol=1e-4)
    for f in ("x", "q", "delta"):
        for a, b in zip(getattr(jw2.bodies, f), getattr(tw2.bodies, f)):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0, err_msg=f)
    for a, b in zip(jw2.bodies.inv_moment, tw2.bodies.inv_moment):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)

    # warm rows: the keys exactly, the accumulators on the rows that count
    for f in ("partner", "key2"):
        np.testing.assert_array_equal(getattr(jw2.warm, f),
                                      getattr(tw2.warm, f), err_msg=f)
    live = jw2.warm.partner != -9
    assert live.sum() == int(jm["num_contacts"])
    for f in ("acc_n", "acc_t1", "acc_t2"):
        np.testing.assert_allclose(getattr(jw2.warm, f)[live],
                                   getattr(tw2.warm, f)[live], atol=2e-4,
                                   rtol=1e-4, err_msg=f)
    # the cache: indices exactly, anchors and slack to rounding
    for f in ("partner", "ok", "overflow", "count"):
        np.testing.assert_array_equal(getattr(jw2.bp, f),
                                      getattr(tw2.bp, f), err_msg=f)
    for a, b in zip(jax.tree_util.tree_leaves(jw2.bp),
                    jax.tree_util.tree_leaves(tw2.bp)):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


def _tree_equal(a, b, valid=None):
    """Every leaf equal bit for bit (on the lanes of ``valid`` where
    given: an invalid slot holds whatever the case not taken computed)."""
    la = jax.tree_util.tree_leaves(a, is_leaf=torch.is_tensor)
    lb = jax.tree_util.tree_leaves(b, is_leaf=torch.is_tensor)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.shape == y.shape and x.dtype == y.dtype
        if valid is not None:
            x, y = x[valid], y[valid]
        assert torch.equal(x, y)


def _contacts_equal(a, b):
    assert torch.equal(a.valid, b.valid)
    _tree_equal(a, b, a.valid)


@pytest.mark.parametrize("manifold", ["ends", "mid"])
def test_split_contacts_bit_identical(jax_mixed, manifold):
    """_pair_contact_split and _terrain_contact_split against the
    unpartitioned routines on the pile's own pairs: every field of every
    slot equal bit for bit."""
    states, cfg = jax_mixed
    w = world_from_numpy(states["reuse"][0], CPU)
    tcfg = WorldConfig(*cfg)._replace(cap_manifold=manifold)
    ns = tcfg.n_sphere_rows
    state = integrate(complete_motion(w.bodies), tcfg.dt, iso=False)
    sv = tworld.shape_view(state)
    ga = tworld.self_shapes(tcfg, sv)
    cols2 = torch.where(w.bp.ok, w.bp.partner, 0).T
    gb = tworld.gather_shapes(tcfg, tworld.pack_shapes(sv, "mixed"), cols2)
    whole = tworld._pair_contact(tcfg, ga, gb)
    split = tworld._pair_contact_split(tcfg, ga, gb, ns)
    assert whole.valid.shape == (2,) + tuple(cols2.shape)
    assert int((whole.valid & w.bp.ok.T[None]).sum()) > 1000
    _contacts_equal(whole, split)

    rng = np.random.default_rng(5)
    pick = torch.as_tensor(rng.integers(0, 10, (3, state.n_bodies)))
    tri = tree_map(lambda c: c[pick], w.terrain)
    assert isinstance(tri, Triangle)
    whole = tworld._terrain_contact(tcfg, ga, tri)
    split = tworld._terrain_contact_split(tcfg, ga, tri, ns)
    assert int(whole.valid.sum()) > 50
    assert int(whole.valid[1].sum()) > 0        # a capsule lying on a face
    _contacts_equal(whole, split)


def test_split_step_streams_equal_unsplit(jax_mixed):
    """A whole port step with the type partition off (``n_sphere_rows=-1``:
    four contact routines per pair, one Mat3 solve over all 24 rows) emits
    the same contact streams bit for bit; only the solve's order differs
    (two-colour Gauss-Seidel against one Jacobi block)."""
    states, cfg = jax_mixed
    w = world_from_numpy(states["rebuild"][0], CPU)
    tcfg = WorldConfig(*cfg)
    w_s, m_s = step(w, tcfg, collect_contacts=True)
    w_u, m_u = step(w, tcfg._replace(n_sphere_rows=-1),
                    collect_contacts=True)
    for key in ("pair_contacts", "terrain_contacts"):
        _contacts_equal(m_s[key]["contact"], m_u[key]["contact"])
        for k in set(m_s[key]) - {"contact"}:
            assert torch.equal(m_s[key][k], m_u[key][k])
    _tree_equal((w_s.warm.partner, w_s.warm.key2, w_s.bp),
                (w_u.warm.partner, w_u.warm.key2, w_u.bp))
    assert int(m_s["num_contacts"]) == int(m_u["num_contacts"])
    dv = max(float((a - b).abs().max())
             for a, b in zip(w_s.bodies.v, w_u.bodies.v))
    assert dv > 0.0
    assert all(bool(torch.isfinite(c).all()) for c in w_u.bodies.v)


@pytest.mark.parametrize("mode", ["pos", "search"])
def test_warm_match_modes_at_24_rows(jax_mixed, mode):
    """On a cache-reuse step the hybrid match is the positional one, on a
    rebuild step the search: the same step with ``warm_match`` forced to
    that mode is bit-identical."""
    states, cfg = jax_mixed
    kind = "reuse" if mode == "pos" else "rebuild"
    w = world_from_numpy(states[kind][0], CPU)
    tcfg = WorldConfig(*cfg)
    w_h, m_h = step(w, tcfg)
    w_m, m_m = step(w, tcfg._replace(warm_match=mode))
    _tree_equal(w_h, w_m)
    assert float(m_h["warm_hit_frac"]) == float(m_m["warm_hit_frac"]) > 0.5


def test_mixed_mini_steps():
    """Port twin of tests/test_world.py::test_mixed_mini_steps."""
    world, cfg = t_stress_scene(64, mixed=True, device=CPU)
    m = None
    for _ in range(120):
        world, m = step(world, cfg)
    y = world.bodies.x.y.numpy()
    assert not np.isnan(y).any()
    assert y.min() > 0.0  # resting on the floor at y=0
    assert int(m["num_contacts"]) > 0
    assert int(m["broadphase_overflow"]) == 0


def test_mixed_chunk_stepper_runs_off_the_fused_branch():
    """AdaptiveChunkStepper on the generic branch: the stepper clears
    ``adapt_schedule`` (no in-step host read of warm_hit_frac) and reads
    the fraction two chunks late; the physics equals plain stepping while
    the full schedule is on."""
    world, cfg = t_stress_scene(64, mixed=True, device=CPU)
    stepper = AdaptiveChunkStepper(cfg, chunk=4)
    w_c = world
    for _ in range(3):
        w_c, m = stepper.step_chunk(w_c)
    assert m["warm_hit_frac"].shape == (4,)
    assert len(stepper._pending) == 2 and not stepper.hot_on
    w_s = world
    plain = cfg._replace(adapt_schedule=None)
    for _ in range(12):
        w_s, _ = step(w_s, plain)
    _tree_equal(w_c.bodies, w_s.bodies)
    # a settled read engages the hot schedule after `patience` chunks
    stepper._pending = [torch.tensor(1.0), torch.tensor(1.0)]
    stepper.step_chunk(w_c)
    stepper.step_chunk(w_c)
    assert stepper.hot_on


def _pos(world):
    return np.stack([c.numpy() for c in world.bodies.x], -1)


def _steps(world, cfg, n):
    for _ in range(n):
        world, _ = step(world, cfg)
    return world


def test_warm_gamma_semantics():
    """Port twin of tests/test_step_features.py::test_warm_gamma_semantics
    (warm starting on the generic branch, dense terrain): gamma=0 is step
    for step a zeroed warm cache, gamma=1 the default."""
    b = SceneBuilder()
    b.add_sphere((0.0, 0.5, 0.0), 0.5, 1.0, 0.0, 0.6)
    b.add_sphere((0.0, 1.5, 0.0), 0.5, 1.0, 0.0, 0.6)
    verts = np.asarray([[-5, 0, -5], [-5, 0, 5], [5, 0, 5], [5, 0, -5]],
                       np.float32)
    faces = np.asarray([(0, 1, 3), (1, 2, 3)], np.int32)
    world = make_world(b.build(CPU), verts, faces, device=CPU)
    base = WorldConfig(dt=1 / 60, solver_iters=4, solver_inner=2,
                       two_phase=False, shape_mode="spheres", solver="rows",
                       grid=GridConfig(cell_size=2.0, dim=8, bucket_cap=4),
                       max_pairs=4, fatten=0.02, warm_start=True,
                       stable_pairs=True, terrain_bp="dense")
    world = init_warm(world, base)
    w0 = _steps(world, base, 20)               # build nonzero accumulators
    assert float(w0.warm.acc_n.abs().max()) > 0.0
    w_g0 = _steps(w0, base._replace(warm_gamma=0.0), 3)
    w_z = _steps(init_warm(w0, base), base, 3)
    np.testing.assert_array_equal(_pos(w_g0), _pos(w_z))
    w_g1 = _steps(w0, base._replace(warm_gamma=1.0), 3)
    w_d = _steps(w0, base, 3)
    np.testing.assert_array_equal(_pos(w_g1), _pos(w_d))
    # and the transfer matters: a damped warm start moves the stack
    # differently from the full one
    w_g5 = _steps(w0, base._replace(warm_gamma=0.5), 3)
    assert np.abs(_pos(w_g5) - _pos(w_d)).max() > 0.0


def _escaped(x, wall):
    """Bodies below y = -1 or outside the walls (chip_smoke.py's count)."""
    return int(((x[:, 1] < -1.0) | (np.abs(x[:, 0]) > wall)
                | (np.abs(x[:, 2]) > wall)).sum())


def test_mixed_reference_meets_smoke_guard(capsys):
    """chip_smoke.py holds the 100k mixed pile, over its first 128 steps,
    to: max penetration < 0.5 at step 128, no escaped body, and a bucket
    overflow of at most 0.05 % of the bodies in any step.  Those limits are
    what mgf_tpu's own mixed pile meets at 2,000 bodies over the same 128
    steps: it passes 0.5 DURING the collapse (so the guard reads the last
    step), and its grid (cell 2.0, cap 14) drops one body of 2,000 on two
    steps (so the overflow guard is a share of the bodies, not zero;
    scripts/mixed_reference_guards.py prints the same series at larger
    sizes).  The port through AdaptiveChunkStepper meets them too.  Piles
    are chaotic: the two runs are held to the guards, not to each other.
    Run with ``-s`` to see the numbers."""
    n, steps = 2000, 128
    jw, jcfg = j_stress_scene(n, mixed=True)
    f = jax.jit(functools.partial(j_step, cfg=jcfg))
    j_pen, j_over = [], []
    for _ in range(steps):
        jw, m = f(jw)
        j_pen.append(float(m["max_penetration"]))
        j_over.append(int(m["broadphase_overflow"]))
    tw, tcfg = t_stress_scene(n, mixed=True, device=CPU)
    wall = float(tw.terrain.a.x.abs().max())
    st = AdaptiveChunkStepper(tcfg, chunk=16)
    t_pen, t_over = [], []
    for _ in range(steps // 16):
        tw, m = st.step_chunk(tw)
        t_pen += m["max_penetration"].tolist()
        t_over += m["broadphase_overflow"].tolist()
    jx = np.stack([np.asarray(c) for c in jw.bodies.x], -1)
    with capsys.disabled():
        print(f"\nmixed pile, {n} bodies, {steps} steps, max penetration: "
              f"mgf_tpu last {j_pen[-1]:.4f} peak {max(j_pen):.4f} (step "
              f"{int(np.argmax(j_pen)) + 1}); port last {t_pen[-1]:.4f} "
              f"peak {max(t_pen):.4f} (step {int(np.argmax(t_pen)) + 1}); "
              f"overflow by step: mgf_tpu "
              f"{ {k + 1: o for k, o in enumerate(j_over) if o} }, port "
              f"{ {k + 1: o for k, o in enumerate(t_over) if o} }")
    assert j_pen[-1] < 0.5 and t_pen[-1] < 0.5
    assert max(j_over) <= 0.0005 * n and max(t_over) <= 0.0005 * n
    assert (_escaped(jx, wall), _escaped(_pos(tw), wall)) == (0, 0)
    assert np.isfinite(_pos(tw)).all()
    assert int(m["num_contacts"][-1]) > 0

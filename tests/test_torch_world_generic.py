"""The port's generic sphere branch (``fused_iso=False``) against mgf_tpu's:
the demo ``balls_scene`` (packed grid, dense terrain, ``terrain_rows=4``)
and the cold reference-schedule pile (bench.py's ``stress_cold20`` row:
``stress_scene`` with warm starting off and 20 two-phase sweeps), both with
``pallas_narrowphase=True`` (kernel K2; its plain version on the CPU, the
Pallas kernel in interpret mode on the JAX side).

The demo state is also stepped with warm starting on (the search match at
16 + 4 rows, ``demo_warm``) and with ``use_grid=False`` (all-pairs
candidates, ``demo_allpairs``).

A JAX state crosses the numpy bridge and one port step is compared with one
JAX step.  Tolerances and their reasons:

* index streams, validity masks, metrics counts and the broadphase cache
  indices: exact (integer work on identical inputs);
* contact normals atol 1e-4; contact times as tests/test_torch_world.py
  (1e-4 where the body approaches the contact plane faster than 0.01 per
  step, else 1e-6 of travel along the normal: t = (r - dist) / (n . v)
  divides rounding noise by a tiny n . v);
* v and omega after the solve: atol 2e-4.  20 two-phase sweeps are 40
  Jacobi half-sweeps, each summing up to 16 + 4 rows per body in another
  order than XLA's fused reductions, and the demo's landing bodies hit at
  ~20 m/s; measured on the CPU: 2.4e-7 (demo) and 2.0e-5 (cold pile).
"""

import functools
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mgf_tpu.scenes import balls_scene as j_balls_scene  # noqa: E402
from mgf_tpu.scenes import stress_scene as j_stress_scene  # noqa: E402
from mgf_tpu.world import init_warm as j_init_warm  # noqa: E402
from mgf_tpu.world import step as j_step  # noqa: E402

from mgf_tpu_torch import world_from_numpy, world_to_numpy  # noqa: E402
from mgf_tpu_torch import world as tworld  # noqa: E402
from mgf_tpu_torch.broadphase import GridConfig  # noqa: E402
from mgf_tpu_torch.compound import compound_from_parts  # noqa: E402
from mgf_tpu_torch.manifold import Manifold  # noqa: E402
from mgf_tpu_torch.math3d import Vec3  # noqa: E402
from mgf_tpu_torch.mesh import mesh_from_arrays  # noqa: E402
from mgf_tpu_torch.physics import SceneBuilder  # noqa: E402
from mgf_tpu_torch.scenes import _TERRAIN_FACES, _TERRAIN_VERTS  # noqa: E402
from mgf_tpu_torch.scenes import balls_scene as t_balls_scene  # noqa: E402
from mgf_tpu_torch.scenes import stress_scene as t_stress_scene  # noqa: E402
from mgf_tpu_torch.scenes import terrain_scene as t_terrain_scene  # noqa: E402
from mgf_tpu_torch.world import (  # noqa: E402
    WorldConfig, init_bp_cache, init_warm, make_world, step,
)

CPU = "cpu"


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def cold_cfg(cfg):
    """bench.py's stress_cold20 row: the reference's solver schedule."""
    return cfg._replace(warm_start=False, fused_iso=False,
                        warm_match="search", adapt_schedule=None,
                        solver_iters=20, solver_inner=1, two_phase=True,
                        pallas_narrowphase=True)


@pytest.fixture(scope="module")
def jax_states():
    """JAX states to step from: the 217-ball demo mid-landing (150 steps:
    the bottom layer is on the floor, the rest still falling onto it) and
    an 800-body cold pile after 100 steps of its collapse."""
    out = {}
    w, cfg = j_balls_scene(6)
    cfg = cfg._replace(pallas_narrowphase=True)
    f = jax.jit(functools.partial(j_step, cfg=cfg))
    for _ in range(150):
        w, _ = f(w)
    out["demo"] = (w, cfg)
    # warm starting on the generic branch: two warm JAX steps fill the
    # accumulators, so the compared step matches non-trivial rows
    wcfg = cfg._replace(warm_start=True)
    fw = jax.jit(functools.partial(j_step, cfg=wcfg))
    ww = j_init_warm(w, wcfg)
    for _ in range(2):
        ww, _ = fw(ww)
    out["demo_warm"] = (ww, wcfg)
    out["demo_allpairs"] = (w, cfg._replace(use_grid=False))
    w, cfg = j_stress_scene(800)
    cfg = cold_cfg(cfg)
    w = w._replace(warm=None)
    f = jax.jit(functools.partial(j_step, cfg=cfg))
    for _ in range(100):
        w, _ = f(w)
    out["cold"] = (w, cfg)
    return out


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
    assert v.sum() >= min_valid, v.sum()
    for a, b in zip(jc.n, tc.n):
        np.testing.assert_allclose(a[v], b[v], atol=1e-4, rtol=0)
    dt = np.abs(jc.t[v] - tc.t[v])
    s = approach[v]
    fast = s >= 1e-2
    assert (dt[fast] <= 1e-4).all(), dt[fast].max()
    assert (dt[~fast] * s[~fast] <= 1e-6).all()


@pytest.mark.parametrize("scene,min_pair,min_ter", [
    ("demo", 200, 30), ("cold", 2000, 100), ("demo_warm", 200, 30),
    ("demo_allpairs", 200, 30)])
def test_one_step_matches_jax(jax_states, scene, min_pair, min_ter):
    jw, cfg = jax_states[scene]
    fc = jax.jit(functools.partial(j_step, cfg=cfg, collect_contacts=True))
    jw2, jm = _np_tree(fc(jw))
    tw2, tm = step(world_from_numpy(_np_tree(jw), CPU), WorldConfig(*cfg),
                   collect_contacts=True)
    tm, tw2 = world_to_numpy(tm), world_to_numpy(tw2)

    d = [np.asarray(c) for c in tw2.bodies.delta]
    pc = jm["pair_contacts"]
    n_pair = [np.asarray(c).ravel() for c in pc["contact"].n]
    pair_app = _approach([c[pc["i"]] for c in d], [c[pc["j"]] for c in d],
                         n_pair).reshape(pc["contact"].t.shape)
    _assert_stream(pc, tm["pair_contacts"], pair_app, min_pair)
    tcn = jm["terrain_contacts"]
    n_ter = [np.asarray(c).ravel() for c in tcn["contact"].n]
    z = np.zeros_like(tcn["i"], np.float32)
    ter_app = _approach([c[tcn["i"]] for c in d], [z, z, z],
                        n_ter).reshape(tcn["contact"].t.shape)
    _assert_stream(tcn, tm["terrain_contacts"], ter_app, min_ter)

    for k in ("broadphase_overflow", "broadphase_rebuilt", "num_contacts",
              "num_pairs", "num_constraints", "num_alive"):
        assert int(jm[k]) == int(tm[k]), k
    for k in ("max_penetration", "broadphase_reach_excess",
              "broadphase_span_excess", "warm_hit_frac"):
        np.testing.assert_allclose(jm[k], tm[k], atol=1e-5, err_msg=k)
    for f in ("v", "omega"):
        for a, b in zip(getattr(jw2.bodies, f), getattr(tw2.bodies, f)):
            np.testing.assert_allclose(a, b, atol=2e-4, rtol=0, err_msg=f)
    for f in ("x", "q", "delta"):
        for a, b in zip(getattr(jw2.bodies, f), getattr(tw2.bodies, f)):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0, err_msg=f)
    if scene == "demo_warm":
        # the search match found last step's rows; keys exactly, the
        # accumulators on live rows
        assert float(tm["warm_hit_frac"]) > 0.5
        for f in ("partner", "key2"):
            np.testing.assert_array_equal(getattr(jw2.warm, f),
                                          getattr(tw2.warm, f), err_msg=f)
        live = jw2.warm.partner != -9
        for f in ("acc_n", "acc_t1", "acc_t2"):
            np.testing.assert_allclose(getattr(jw2.warm, f)[live],
                                       getattr(tw2.warm, f)[live],
                                       atol=2e-4, rtol=1e-4, err_msg=f)
    else:
        assert tw2.warm is None
    if scene == "cold":
        # the cached fat grid: indices exactly, anchors to rounding
        for f in ("partner", "ok", "overflow", "count"):
            np.testing.assert_array_equal(getattr(jw2.bp, f),
                                          getattr(tw2.bp, f), err_msg=f)
        for a, b in zip(jax.tree_util.tree_leaves(jw2.bp),
                        jax.tree_util.tree_leaves(tw2.bp)):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    else:
        # the demo's dense terrain under terrain_rows=4: the solve sums
        # the selected rows, so a wrong selection moves v and omega well
        # past the tolerance above; the stepped bodies really touch
        assert int(tm["num_contacts"]) > 200



def test_demo_overflow_series_matches_jax():
    """The demo's own grid (cell 2.0, bucket cap 10) overflows while the
    11^3 block lands, in mgf_tpu as in the port.  JAX steps balls_scene(11)
    for chip_smoke.py's 280-step window; the port steps from JAX's state
    at step 140 (free fall, no contact yet), and its per-step
    broadphase_overflow series equals JAX's step for step.  chip_smoke.py
    guards this series on the card: at most JAX's peak of 96 during the
    landing, and none from step 201 on."""
    jw, cfg = j_balls_scene(11)
    cfg = cfg._replace(pallas_narrowphase=True)
    f = jax.jit(functools.partial(j_step, cfg=cfg))
    j_over, start = [], None
    for k in range(280):
        jw, m = f(jw)
        j_over.append(int(m["broadphase_overflow"]))
        if k + 1 == 140:
            start = _np_tree(jw)
    tw, tcfg = world_from_numpy(start, CPU), WorldConfig(*cfg)
    t_over = []
    for _ in range(140):
        tw, m = step(tw, tcfg)
        t_over.append(int(m["broadphase_overflow"]))
    assert not any(j_over[:140])
    assert t_over == j_over[140:]
    assert max(j_over) == 96
    assert any(j_over[140:200]) and not any(j_over[200:])

def test_narrowphase_kernel_switch(jax_states, monkeypatch):
    """pallas_narrowphase routes the pair contact through K2's wrapper
    (here its plain version); the other path is the branch-free collision
    code.  Same contacts, same step, at the tolerances above."""
    jw, cfg = jax_states["demo"]
    calls = []

    def counting(ga8, gb8):
        calls.append(ga8.shape)
        return sphere_contact_pairs(ga8, gb8)

    sphere_contact_pairs = tworld.sphere_contact_pairs
    monkeypatch.setattr(tworld, "sphere_contact_pairs", counting)
    w0 = world_from_numpy(_np_tree(jw), CPU)
    tcfg = WorldConfig(*cfg)
    w_k, m_k = step(w0, tcfg, collect_contacts=True)
    n, K = w0.bodies.n_bodies, tcfg.max_pairs
    assert calls == [(8, K * n)]
    w_p, m_p = step(w0, tcfg._replace(pallas_narrowphase=False),
                    collect_contacts=True)
    assert len(calls) == 1
    ck, cp = m_k["pair_contacts"]["contact"], m_p["pair_contacts"]["contact"]
    assert torch.equal(ck.valid, cp.valid)
    v = ck.valid
    for a, b in zip([*ck.n, ck.t], [*cp.n, cp.t]):
        torch.testing.assert_close(a[v], b[v], atol=1e-4, rtol=0)
    for f in ("v", "omega"):
        for a, b in zip(getattr(w_k.bodies, f), getattr(w_p.bodies, f)):
            torch.testing.assert_close(a, b, atol=2e-4, rtol=0)


def test_terrain_rows_selection_matches_lax_top_k():
    """The terrain_rows selection keeps lax.top_k's order (descending
    score, the LOWER row first among equal scores), on rows with many
    ties: invalid rows score 0, overlaps (time 0) score 2."""
    rng = np.random.default_rng(4)
    T, N, kk = 10, 300, 4
    valid = rng.uniform(size=(T, N)) < 0.3
    time = np.where(rng.uniform(size=(T, N)) < 0.6, 0.0,
                    rng.choice([0.25, 0.5, 1.0], (T, N))).astype(np.float32)
    key2 = np.broadcast_to(np.arange(T, dtype=np.int32)[:, None], (T, N))
    score = valid.astype(np.float32) * (2.0 - time)
    _, idx = jax.lax.top_k(jnp.asarray(score.T), kk)
    want = np.take_along_axis(key2, np.asarray(idx).T, axis=0)
    f = lambda a: torch.as_tensor(np.ascontiguousarray(a))
    v3 = lambda: Vec3(f(time), f(time), f(time))
    tman = Manifold(time=f(time), normal=v3(), t1=v3(), t2=v3(),
                    local_a=v3(), local_b=v3(), valid=f(valid))
    got_man, got = tworld._top_terrain_rows(tman, f(key2), kk)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got_man.valid.numpy(), np.take_along_axis(valid, want, axis=0))
    # ties decide: some body has more than kk rows at the top score
    assert ((score == 2.0).sum(axis=0) > kk).any()


@pytest.mark.parametrize("num,with_dropped", [(6, True), (3, False)])
def test_balls_scene_matches_jax(num, with_dropped):
    jw, jcfg = j_balls_scene(num, with_dropped)
    tw, tcfg = t_balls_scene(num, with_dropped, device=CPU)
    a = jax.tree_util.tree_leaves(_np_tree(jw))
    b = jax.tree_util.tree_leaves(world_to_numpy(tw))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
    assert tuple(jcfg) == tuple(tcfg)


def test_balls_mini_settles():
    """Port twin of tests/test_world.py::test_balls_mini_settles, and the
    block settles where mgf_tpu's does: within 1e-3 after 400 steps
    (resting contacts; eager float32 against XLA's fused code), the same
    contact count."""
    world, cfg = t_balls_scene(num=2, with_dropped=False, device=CPU)
    m = None
    for _ in range(400):
        world, m = step(world, cfg)
    y = world.bodies.x.y.numpy()
    vy = world.bodies.v.y.numpy()
    assert not np.isnan(y).any()
    assert y.min() > -10.0 and y.max() < 0.0
    assert np.abs(vy).max() < 1.0
    assert int(m["num_contacts"]) > 0
    assert int(m["broadphase_overflow"]) == 0
    jw, jcfg = j_balls_scene(num=2, with_dropped=False)
    f = jax.jit(functools.partial(j_step, cfg=jcfg))
    for _ in range(400):
        jw, jm = f(jw)
    np.testing.assert_allclose(y, np.asarray(jw.bodies.x.y), atol=1e-3)
    assert int(m["num_contacts"]) == int(jm["num_contacts"])


def test_balls_contact_stream_parity():
    """Port twin of tests/test_oracle.py::test_balls_contact_stream_parity:
    each step the f64 oracle's state goes into the port's generic step (the
    packed grid, dense terrain) and the two contact streams are diffed
    contact for contact, at the same gates.  A shorter window: the oracle
    runs the free fall alone, and 60 steps of the landing are diffed."""
    from mgf_tpu import oracle
    from test_oracle import _diff_streams

    jworld, cfg = j_balls_scene(num=6, with_dropped=True)   # 217 bodies
    tcfg = WorldConfig(*cfg)
    ow = oracle.from_world(jworld)
    for _ in range(135):
        ow, _ = oracle.oracle_step(ow, dt=cfg.dt, iters=cfg.solver_iters,
                                   mgf_friction=True)
    worst = dict(dt=0.0, dn=0.0, dp=0.0, miss=0, total=0)
    for _ in range(60):
        w_in = world_from_numpy(_np_tree(oracle.to_world(ow, jworld)), CPU)
        _, m = step(w_in, tcfg, collect_contacts=True)
        ow, rec = oracle.oracle_step(ow, dt=cfg.dt, iters=cfg.solver_iters,
                                     mgf_friction=True)
        worst = _diff_streams(world_to_numpy(m), rec, worst)
    assert worst["total"] > 300, worst          # the landing is in window
    assert worst["miss"] == 0, worst
    assert worst["dt"] <= 1e-4, worst
    assert worst["dn"] <= 2e-7, worst
    assert worst["dp"] <= 2e-6, worst


def test_generic_off_slice_configs_raise():
    """Every configuration runs on the generic branch: the octant fat
    grid and bp_margin (no cache state, so an uncached build) give
    mgf_tpu's pair stream, a broadphase name that is no fat mode runs the
    packed grid as mgf_tpu's does, and those that the flat solvers, the
    face grid and the row compaction brought in run (finite velocities);
    "grid" without a face table is refused as mgf_tpu refuses it."""
    world, cfg = t_balls_scene(2, device=CPU)
    jw, jcfg = j_balls_scene(2)
    stream = lambda m: (m["pair_contacts"]["i"], m["pair_contacts"]["j"],
                        m["pair_contacts"]["contact"].valid)
    for over in (dict(broadphase="fat8x4"), dict(bp_margin=0.5),
                 dict(broadphase="grid")):
        w2, m = step(world, cfg._replace(**over), collect_contacts=True)
        assert all(bool(torch.isfinite(c).all()) for c in w2.bodies.v)
        if over == dict(broadphase="grid"):
            # no fat mode: the packed grid, the same step as "packed"
            _, m_packed = step(world, cfg, collect_contacts=True)
            for a, b in zip(stream(world_to_numpy(m)),
                            stream(world_to_numpy(m_packed))):
                np.testing.assert_array_equal(a, b)
            continue
        jm = jax.jit(functools.partial(j_step, cfg=jcfg._replace(**over),
                                       collect_contacts=True))(jw)[1]
        for a, b in zip(stream(_np_tree(jm)), stream(world_to_numpy(m))):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        step(world, cfg._replace(terrain_bp="grid"))
    tg = GridConfig(cell_size=4.0, dim=16, bucket_cap=8)
    gworld = make_world(world.bodies, _TERRAIN_VERTS, _TERRAIN_FACES,
                        terrain_center=(0.0, -10.0, 0.0),
                        terrain_grid_cfg=tg, device=CPU)
    for good, w in ((cfg._replace(solver_rows=8), world),
                    (cfg._replace(terrain_bp="grid", terrain_grid_cfg=tg),
                     gworld),
                    (cfg._replace(solver="sequential"), world),
                    (cfg._replace(solver="parallel"), world)):
        w2, m = step(w, good)
        assert all(bool(torch.isfinite(c).all()) for c in w2.bodies.v)
        assert int(m["solver_rows_dropped"]) == 0


def test_entry_points_default_to_the_card():
    """Scenes, make_world and SceneBuilder.build run on the card unless
    the caller names a device; init_warm and init_bp_cache follow the
    world's own device."""
    cuda = torch.device("cuda")
    for fn in (t_balls_scene, t_stress_scene, t_terrain_scene, make_world,
               SceneBuilder.build, mesh_from_arrays, compound_from_parts):
        assert inspect.signature(fn).parameters["device"].default == cuda
    world, cfg = t_balls_scene(2, device=CPU)
    w = init_bp_cache(init_warm(world, cfg), cfg)
    for t in jax.tree_util.tree_leaves((w.warm, w.bp),
                                       is_leaf=torch.is_tensor):
        assert t.device.type == "cpu"

"""The port's ``bp_margin`` refit cache on the flagship (fused) branch
against mgf_tpu's, in both forms: alone (``bp_every=1``: rebuild when a
body drifts past margin/2) and combined with the ``bp_every`` cadence.

Each step of a 12-step series starts from mgf_tpu's state, so the two
packages see the same inputs on rebuild and reuse steps alike: the
rebuild flags, the pair streams and the cache's integer fields must be
equal, its anchors, slacks and build radii within 1e-6, the drift excess
within 1e-6.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from mgf_tpu.scenes import stress_scene as j_stress_scene  # noqa: E402
from mgf_tpu.world import init_bp_cache as j_init_bp_cache  # noqa: E402
from mgf_tpu.world import step as j_step  # noqa: E402

from mgf_tpu_torch import world_from_numpy, world_to_numpy  # noqa: E402
from mgf_tpu_torch.world import WorldConfig, step  # noqa: E402
from test_torch_world_variants import _np_tree, _to_jax, _variant  # noqa: E402

CPU = "cpu"


def _resync_series(np_world, cfg, n_steps):
    """Each step: mgf_tpu steps its state, the port steps the same numpy
    state; the rebuild flags, the pair streams and the carried cache are
    held equal.  Returns the rebuild series."""
    f = jax.jit(functools.partial(j_step, cfg=cfg, collect_contacts=True))
    tcfg = WorldConfig(*cfg)
    jw = _to_jax(np_world)
    series = []
    for _ in range(n_steps):
        tw2, tm = step(world_from_numpy(_np_tree(jw), CPU), tcfg,
                       collect_contacts=True)
        jw, jm = f(jw)
        jm, tm = _np_tree(jm), world_to_numpy(tm)
        rebuilt = bool(jm["broadphase_rebuilt"])
        assert bool(tm["broadphase_rebuilt"]) == rebuilt
        series.append(rebuilt)
        for k in ("i", "j"):
            np.testing.assert_array_equal(jm["pair_contacts"][k],
                                          tm["pair_contacts"][k])
        np.testing.assert_array_equal(jm["pair_contacts"]["contact"].valid,
                                      tm["pair_contacts"]["contact"].valid)
        assert int(jm["broadphase_overflow"]) == int(
            tm["broadphase_overflow"]) == 0
        np.testing.assert_allclose(jm["broadphase_cache_drift_excess"],
                                   tm["broadphase_cache_drift_excess"],
                                   atol=1e-6)
        jbp, tbp = _np_tree(jw.bp), world_to_numpy(tw2.bp)
        for f_ in ("partner", "ok", "overflow", "count"):
            np.testing.assert_array_equal(getattr(jbp, f_),
                                          getattr(tbp, f_))
        for a, b in zip(jax.tree_util.tree_leaves((jbp.anchor, jbp.slack,
                                                   jbp.r_build)),
                        jax.tree_util.tree_leaves((tbp.anchor, tbp.slack,
                                                   tbp.r_build))):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    return series


@pytest.fixture(scope="module")
def floor_layer():
    """A settled layer: 36 spheres resting on a floor 1.02 apart (bounds
    overlapping, no contact), and one sphere sliding along the row at
    0.6 m/s, whose drift trips the refit cache every few steps.  Stepped
    10 steps by the port; returns (numpy state, world without caches,
    config)."""
    from mgf_tpu.physics import SceneBuilder as JBuilder
    from mgf_tpu.world import init_warm as j_init_warm
    box, cfg = j_stress_scene(100)            # the scene's box, |x|, |z| < 8
    cfg = cfg._replace(pallas_solver=False, solver_iters=2, solver_inner=2,
                       adapt_schedule=None)
    g = np.arange(6) * 1.02 - 2.5
    pos = np.stack(np.meshgrid(g, [0.5], g, indexing="ij"),
                   -1).reshape(-1, 3).astype(np.float32)
    b = JBuilder()
    b.add_spheres(pos, 0.5, mass=1.0, restitution=0.3, friction=0.6)
    b.add_sphere((-4.5, 0.5, 0.05), 0.5, 1.0, 0.3, 0.0)
    jw = j_init_warm(box._replace(bodies=b.build(), warm=None, bp=None), cfg)
    jw = jw._replace(bodies=jw.bodies._replace(v=jw.bodies.v._replace(
        x=jw.bodies.v.x.at[-1].set(0.6))))
    tw = world_from_numpy(_np_tree(jw), CPU)
    for _ in range(10):
        tw, m = step(tw, WorldConfig(*cfg))
    assert int(m["num_contacts"]) >= 36
    return world_to_numpy(tw), cfg


@pytest.mark.parametrize("bp_every,margin,mode", [(1, 0.1, "fat27x4"),
                                                   (8, 0.1, "fat8x4")])
def test_bp_margin_series_matches_jax(floor_layer, bp_every, margin,
                                      mode):
    """The refit cache alone (bp_every=1: rebuild when a body drifts past
    margin/2) and combined with the cadence cache (bp_every=8: the drift
    test joins the cadence and staleness triggers, the build fattened by
    fatten + margin before the slack, whose budget the octant mode
    halves): 12 steps from a fresh cache, each from mgf_tpu's state,
    rebuild and reuse steps alike."""
    np_world, cfg = floor_layer
    c = _variant(cfg, mode)._replace(bp_every=bp_every, bp_margin=margin)
    jw = j_init_bp_cache(_to_jax(np_world), c)
    series = _resync_series(_np_tree(jw), c, 12)
    assert series[0] and not all(series), series
    # the sliding body's drift (0.01 a step) trips the margin/2 test on
    # the sixth step after a build, before the cadence's eighth
    assert series[:6] == [True] + [False] * 4 + [True], series

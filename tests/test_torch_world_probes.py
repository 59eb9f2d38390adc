"""The port's ``profile_stage`` probes against mgf_tpu's: after the named
stage both steps return the INPUT world and ``{"probe": scalar}`` with the
same probe expression.

Every stage on the fused flagship branch (a 400-body stress pile after
60 steps, the solver schedule cut to 2 x 2 sweeps: each stage is its own
JAX compile), one on the generic branch and one on the flat solver; on
the flat solver a stage past "terrain" runs the full step, as in the JAX
package.  Integer probes (sums of masks and indices, int32 on both sides)
must be equal.  Float probes sum thousands of per-row values, each within
test_torch_world.py's step tolerances (contact normals and times 1e-4),
reduced in another order than XLA's: they are held to 1e-3 relative plus
1e-3, and the "solve" probe, a sum of 2N velocities each within 2e-4, to
2e-4 per summed value.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from mgf_tpu.scenes import balls_scene as j_balls_scene  # noqa: E402
from mgf_tpu.scenes import stress_scene as j_stress_scene  # noqa: E402
from mgf_tpu.world import step as j_step  # noqa: E402

from mgf_tpu_torch import world_from_numpy, world_to_numpy  # noqa: E402
from mgf_tpu_torch.world import WorldConfig, step  # noqa: E402

CPU = "cpu"
STAGES = ("integrate", "pairs", "narrow", "terrain", "rows", "constraints",
          "warm", "solve")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _state(jw, cfg, n_steps):
    """The numpy state after ``n_steps`` port steps from mgf_tpu's scene."""
    tw = world_from_numpy(_np_tree(jw), CPU)
    for _ in range(n_steps):
        tw, _ = step(tw, WorldConfig(*cfg))
    return world_to_numpy(tw)


def _assert_probe(np_world, cfg, stage):
    c = cfg._replace(profile_stage=stage)
    jw_in = jax.tree_util.tree_map(jax.numpy.asarray, np_world)
    jw, jm = jax.jit(functools.partial(j_step, cfg=c))(jw_in)
    tw_in = world_from_numpy(np_world, CPU)
    tw, tm = step(tw_in, WorldConfig(*c))
    assert set(tm) == set(jm) == {"probe"}
    # the input world comes back, not advanced
    assert tw is tw_in
    j, t = np.asarray(jm["probe"]), tm["probe"].numpy()
    assert j.dtype == t.dtype and j.shape == t.shape == ()
    assert np.isfinite(t)
    if j.dtype == np.int32:
        assert int(j) == int(t), stage
    elif stage == "solve":
        n_vals = 2 * np_world.bodies.x.x.shape[0]
        np.testing.assert_allclose(t, j, atol=2e-4 * n_vals, rtol=0)
    else:
        np.testing.assert_allclose(t, j, atol=1e-3, rtol=1e-3, err_msg=stage)
    return t


@pytest.fixture(scope="module")
def fused_pile():
    jw, cfg = j_stress_scene(400, layers=4)
    cfg = cfg._replace(pallas_solver=False, solver_iters=2, solver_inner=2,
                       adapt_schedule=None)
    return _state(jw, cfg, 60), cfg


@pytest.mark.parametrize("stage", STAGES)
def test_fused_stage_probe_matches_jax(fused_pile, stage):
    np_world, cfg = fused_pile
    _assert_probe(np_world, cfg, stage)


def test_generic_stage_probe_matches_jax():
    """The demo's generic branch (packed grid, dense terrain, cold
    two-phase solve) after the block landed, probed after its
    constraint build."""
    jw, cfg = j_balls_scene(num=3, with_dropped=False)
    np_world = _state(jw, cfg, 150)
    _assert_probe(np_world, cfg, "constraints")


def test_flat_stage_probe_matches_jax_and_later_stages_run_the_step():
    """The flat sequential solver: "narrow" is a probe; the stages after
    "terrain" exist on the rows solver only, so "warm" runs the whole
    step, the same as no stage."""
    jw, cfg = j_balls_scene(num=3, with_dropped=False, solver="sequential")
    np_world = _state(jw, cfg, 150)
    _assert_probe(np_world, cfg, "narrow")
    tcfg = WorldConfig(*cfg)
    w_full, m_full = step(world_from_numpy(np_world, CPU), tcfg)
    w_warm, m_warm = step(world_from_numpy(np_world, CPU),
                          tcfg._replace(profile_stage="warm"))
    assert "probe" not in m_warm and int(m_warm["num_contacts"]) > 0
    for a, b in zip(world_to_numpy(w_full.bodies),
                    world_to_numpy(w_warm.bodies)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

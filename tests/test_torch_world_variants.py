"""The port's broadphase modes "fat", "fat8" and "fat8x4" on the flagship
(fused) branch, against mgf_tpu's step on the same states (the
``bp_margin`` refit cache is test_torch_world_refit.py).

The shared state is mgf_tpu's stress_scene(800, layers=4) after 90
steps (stepped by the port; both packages then read the same numpy
state).  The solver schedule is cut to 2 x 2 sweeps: the broadphase is
what these tests hold, and each JAX configuration is its own compile.
Tolerances are test_torch_world.py's (``_assert_one_step_matches_jax``):
index streams and validity masks exactly; contact normals 1e-4, v and
omega 2e-4, positions 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from mgf_tpu.scenes import stress_scene as j_stress_scene  # noqa: E402

from mgf_tpu_torch import world_from_numpy, world_to_numpy  # noqa: E402
from mgf_tpu_torch.broadphase import GridConfig  # noqa: E402
from mgf_tpu_torch.world import WorldConfig, step  # noqa: E402
from test_torch_world import _assert_one_step_matches_jax  # noqa: E402

CPU = "cpu"
# the octant window guarantees pair reach up to half a cell: the scene's
# sel8 grid (cell 2.4, cap 24; mgf_tpu/scenes.py:255-261)
SEL8_GRID = GridConfig(cell_size=2.4, dim=(16, 16, 16), bucket_cap=24)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _to_jax(np_world):
    return jax.tree_util.tree_map(jax.numpy.asarray, np_world)


@pytest.fixture(scope="module")
def shared():
    """(numpy state after 60 steps, the cut JAX config)."""
    jw, cfg = j_stress_scene(800, layers=4)
    cfg = cfg._replace(pallas_solver=False, solver_iters=2, solver_inner=2,
                       adapt_schedule=None)
    tw = world_from_numpy(_np_tree(jw), CPU)
    tcfg = WorldConfig(*cfg)
    for _ in range(90):
        tw, m = step(tw, tcfg)
    assert int(m["num_contacts"]) > 1000
    return world_to_numpy(tw), cfg


def _variant(cfg, mode):
    c = cfg._replace(broadphase=mode)
    if mode in ("fat8", "fat8x4"):
        c = c._replace(grid=type(cfg.grid)(*SEL8_GRID))
    return c


@pytest.mark.parametrize("mode", ["fat", "fat8", "fat8x4"])
def test_one_step_fat_mode_matches_jax(shared, mode):
    """One uncached build (no cache state) in each mode: pair and terrain
    streams exact, the step's state at test_torch_world.py's tolerance."""
    np_world, cfg = shared
    _assert_one_step_matches_jax(_to_jax(np_world._replace(bp=None)),
                                 _variant(cfg, mode))


@pytest.mark.parametrize("mode", ["fat8", "fat8x4"])
def test_octant_modes_halve_the_guarantee(shared, mode):
    """fat8 / fat8x4 guarantee pair reach up to half a cell only
    (mgf_tpu/world.py:711-712): on the flagship's own grid (cell 1.6) the
    pile's reach (two swept fat radii, ~1.1) is within the 27-cell
    window's guarantee and past the octant's 0.8, by exactly what the
    27-cell window reports at cell 0.8."""
    np_world, cfg = shared
    tw = world_from_numpy(np_world._replace(bp=None), CPU)
    tcfg = WorldConfig(*cfg)
    g = tcfg.grid
    _, m27 = step(tw, tcfg._replace(broadphase="fat27x4"))
    _, m8 = step(tw, tcfg._replace(broadphase=mode))
    _, m_half = step(tw, tcfg._replace(
        broadphase="fat27x4", grid=g._replace(cell_size=0.5 * g.cell_size)))
    assert float(m27["broadphase_reach_excess"]) == 0.0
    excess = float(m8["broadphase_reach_excess"])
    assert excess > 0.2
    assert excess == float(m_half["broadphase_reach_excess"])

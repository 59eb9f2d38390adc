"""tests/test_terrain.py's two free runs on the port alone, with the JAX
tests' own bars: the face-grid terrain cull against the dense
(body, triangle) narrowphase on the demo box over 200 steps, and the
600-body heightfield scene over 120 steps.  (The JAX-parity checks of the
grid step are in test_torch_world_terrain.py.)"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from mgf_tpu_torch.broadphase import GridConfig  # noqa: E402
from mgf_tpu_torch.scenes import (  # noqa: E402
    _TERRAIN_FACES, _TERRAIN_VERTS, balls_scene, terrain_scene,
)
from mgf_tpu_torch.world import make_world, step  # noqa: E402

CPU = "cpu"


def test_grid_terrain_matches_dense_on_demo_box():
    w_dense, cfg = balls_scene(num=4, with_dropped=True, device=CPU)
    # the demo box's faces are huge (radius ~14): the cell must cover the
    # largest face radius for the +-1-cell window to be exact
    tg = GridConfig(cell_size=16.0, dim=4, bucket_cap=10)
    w_grid = make_world(w_dense.bodies, _TERRAIN_VERTS, _TERRAIN_FACES,
                        terrain_center=(0.0, -10.0, 0.0),
                        terrain_grid_cfg=tg, device=CPU)
    cfg_grid = cfg._replace(terrain_bp="grid", terrain_cand=10,
                            terrain_grid_cfg=tg)
    wa, wb = w_dense, w_grid
    for _ in range(200):
        wa, ma = step(wa, cfg)
        wb, mb = step(wb, cfg_grid)
    assert int(ma["num_contacts"]) == int(mb["num_contacts"]) > 0
    np.testing.assert_allclose(wa.bodies.x.y.numpy(), wb.bodies.x.y.numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(wa.bodies.v.y.numpy(), wb.bodies.v.y.numpy(),
                               atol=1e-3)


def test_heightfield_scene_runs():
    world, cfg = terrain_scene(n_bodies=600, grid_n=40, device=CPU)
    assert world.terrain.a.x.shape[0] >= 3000                 # 3,200 faces
    w = world
    for _ in range(120):
        w, m = step(w, cfg)
    ys = w.bodies.x.y.numpy()
    assert not np.isnan(ys).any()
    # bodies rained from y >= 8 have landed on the heightfield (|h| <= 2)
    assert ys.min() > -4.0
    assert ys.max() < 30.0
    assert int(m["num_contacts"]) > 100
    assert float(m["terrain_reach_excess"]) == 0.0
    # mixed capsule stacks settle at ~0.5 max penetration (the JAX test's
    # bar)
    assert float(m["max_penetration"]) < 0.8

"""test_spatial.py's drift test replayed with the port: bodies sliding
across slab boundaries on 4 gloo CPU ranks beside mgf_tpu on 4 of
conftest's virtual CPU devices.  The stray metric must fire on the same
step as mgf_tpu's, the re-shard (of the gathered world) must restore stray
== 0 with mgf_tpu's new boundaries, and the trajectory must keep matching
the port's single-device run (1e-4) and mgf_tpu's spatial run (the exact
streams and tolerances of test_torch_spatial.py).
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mgf_tpu_torch import world_to_numpy  # noqa: E402
from test_torch_spatial import (  # noqa: E402
    hold_to_jax, jax_spatial, port_single, run_port, sorted_positions,
    spatial_spec,
)


def _drift_world():
    """test_spatial.py's 8 well-separated spheres on the floor, all sliding
    +x: no pair contacts ever, so the physics stays exact while they
    cross the slabs."""
    import jax.numpy as jnp
    from mgf_tpu.broadphase import GridConfig as JGrid
    from mgf_tpu.physics import SceneBuilder
    from mgf_tpu.scenes import _TERRAIN_FACES, _TERRAIN_VERTS
    from mgf_tpu.world import WorldConfig as JConfig, make_world
    b = SceneBuilder()
    nb = 8
    xs = np.linspace(-7.0, 5.0, nb).astype(np.float32)
    pos = np.stack([xs, np.full(nb, -9.5, np.float32),
                    np.zeros(nb, np.float32)], axis=-1)
    b.add_spheres(pos, 0.5, mass=1.0, restitution=0.0, friction=0.0)
    world = make_world(b.build(), _TERRAIN_VERTS, _TERRAIN_FACES,
                       terrain_center=(0.0, -10.0, 0.0))
    world = world._replace(bodies=world.bodies._replace(
        v=world.bodies.v._replace(x=jnp.full(nb, 6.0, jnp.float32))))
    cfg = JConfig(dt=1.0 / 60.0, solver_iters=10, two_phase=False,
                  shape_mode="spheres", solver="rows",
                  grid=JGrid(cell_size=2.0, dim=32, bucket_cap=8),
                  max_pairs=8, fatten=0.1)
    return world, cfg


@pytest.fixture(scope="module")
def runs():
    w, c = _drift_world()
    drift = spatial_spec(w, c, halo=8, halo_width=0.5, steps=24,
                         reshard=True, after=4)
    port = dict(drift=run_port([drift], 4)[0])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jx = dict(drift=jax_spatial(drift, 4))
    return dict(drift=drift), port, jx


def test_spatial_drift_stray_and_reshard(runs):
    """Bodies slide across slab boundaries: the stray metric fires on the
    same step as mgf_tpu's, the re-shard restores stray == 0, and the
    trajectory keeps matching the single-device run."""
    specs, port, jx = runs
    t = port["drift"]
    assert t["stray_step"] < 24, "bodies crossed slabs but stray never fired"
    assert int(t["metrics"][-1]["spatial_stray"]) == 0
    ws, _ = port_single(specs["drift"], len(t["metrics"]))
    np.testing.assert_allclose(sorted_positions(t["final"]["bodies"]),
                               sorted_positions(world_to_numpy(ws.bodies)),
                               atol=1e-4)
    hold_to_jax(jx["drift"], t)

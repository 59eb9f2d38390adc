"""test_spatial.py's mixed terrain pile replayed with the port:
terrain_scene(96, grid_n=16) (spheres and capsules over a heightfield,
the "grid" terrain cull) on 4 gloo CPU ranks beside mgf_tpu on 4 of
conftest's virtual CPU devices, 5 steps.  Its bars hold the port's
spatial step against the port's single-device step (positions 1e-4, equal
contacts); beyond them the exact streams of test_torch_spatial.py, per-row
state within 1e-5 after one step and 1e-4 after five.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mgf_tpu.scenes import terrain_scene as j_terrain_scene  # noqa: E402

from mgf_tpu_torch import world_to_numpy  # noqa: E402
from test_torch_spatial import (  # noqa: E402
    hold_to_jax, jax_spatial, port_single, run_port, sorted_positions,
    spatial_spec,
)


@pytest.fixture(scope="module")
def runs():
    w, c = j_terrain_scene(n_bodies=96, grid_n=16)
    mixed = spatial_spec(w, c._replace(use_grid=True), halo=48, steps=5,
                         snaps=(1,))
    port = dict(mixed=run_port([mixed], 4)[0])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jx = dict(mixed=jax_spatial(mixed, 4))
    return dict(mixed=mixed), port, jx


def test_spatial_mixed_matches_single_device(runs):
    specs, port, jx = runs
    t = port["mixed"]
    ws, ms = port_single(specs["mixed"], 5)
    np.testing.assert_allclose(sorted_positions(t["final"]["bodies"]),
                               sorted_positions(world_to_numpy(ws.bodies)),
                               atol=1e-4)
    assert int(t["metrics"][-1]["num_contacts"]) == int(ms["num_contacts"])
    hold_to_jax(jx["mixed"], t)

"""The port's spatial step on the flagship configuration against mgf_tpu's,
on the same numpy worlds (mgf_tpu on conftest's 8 virtual CPU devices, the
port on 8 gloo ranks on the CPU).

test_spatial_stress_config_matches_single_device replays its namesake of
tests/test_spatial.py: the port's spatial step against the port's
single-device step.  Beyond that, as in test_torch_spatial.py: the shard,
boundaries, halo and comm metrics and the ``broadphase_rebuilt`` series
exactly, each rank's halo membership, candidate lists and warm partner
gids exactly, per-row state within 1e-5 after one step and within the JAX
test's own tolerance (5e-3 for the warm-started stress config) after the
last.  The JAX test's pile first touches the floor on its eighth step, so
an agitated pile (the same spheres squeezed until neighbours overlap, with
random velocities) holds every step of a pile whose contacts cross the
slab edges with impulses.
"""

import warnings

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mgf_tpu.scenes import stress_scene as j_stress_scene  # noqa: E402

from mgf_tpu_torch import world_to_numpy  # noqa: E402
from test_torch_spatial import (  # noqa: E402
    hold_to_jax, jax_spatial, port_single, run_port, sorted_positions,
    spatial_spec,
)

STRESS_ATOL = 5e-3       # test_spatial.py's stress-config tolerance


def _agitated(world):
    """The pile squeezed to 0.9875 apart in x and z (0.79 of 1.25: every
    neighbour overlaps), its bottom layer on the floor, with random
    velocities U(-1, 1) m/s from numpy seed 5."""
    b = world.bodies
    vel = np.random.default_rng(5).uniform(
        -1.0, 1.0, (3, b.x.x.shape[0])).astype(np.float32)
    return world._replace(bodies=b._replace(
        x=b.x._replace(x=b.x.x * 0.79, y=b.x.y - 1.49, z=b.x.z * 0.79),
        v=type(b.v)(*(jax.numpy.asarray(c) for c in vel))))


def _dropped(world):
    """The pile dropped to just above the floor, so contacts and warm rows
    form within the first steps (test_spatial.py's setup)."""
    return world._replace(bodies=world.bodies._replace(
        x=world.bodies.x._replace(y=world.bodies.x.y - 1.4)))


@pytest.fixture(scope="module")
def runs():
    w, c = j_stress_scene(n_bodies=300, layers=3)
    assert c.warm_start and c.stable_pairs and c.fused_iso
    assert c.broadphase in ("fat8x4", "fat27x4") and c.terrain_bp == "near"
    stress = spatial_spec(_dropped(w), c, halo=48,
                          halo_width=c.grid.cell_size, steps=8, snaps=(1,))
    # the agitated pile: the same 300 spheres squeezed to 0.9875 apart
    # in x and z (neighbours overlap), resting on the floor, with random
    # velocities (numpy seed 5, U(-1, 1) m/s): contacts with impulses
    # across every slab edge from the first step on
    agitated = spatial_spec(_agitated(w), c, halo=48,
                            halo_width=c.grid.cell_size, steps=6,
                            snaps=tuple(range(1, 7)))
    port = dict(zip(("stress", "agitated"), run_port([stress, agitated],
                                                      8)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jx = dict(stress=jax_spatial(stress, 8),
                  agitated=jax_spatial(agitated, 8))
    specs = dict(stress=stress, agitated=agitated)
    return specs, port, jx


def test_spatial_stress_config_matches_single_device(runs):
    """The flagship semantics (warm start, stable pairs, fat8x4, the "near"
    terrain cull, fused_iso counts, the bp cache) run sharded and track
    the single-device trajectory."""
    specs, port, jx = runs
    t = port["stress"]
    ws, _ = port_single(specs["stress"], 8)
    np.testing.assert_allclose(sorted_positions(t["final"]["bodies"]),
                               sorted_positions(world_to_numpy(ws.bodies)),
                               atol=STRESS_ATOL)
    m = t["metrics"][-1]
    assert int(m["spatial_stray"]) == 0 and int(m["halo_overflow"]) == 0
    assert int(m["broadphase_overflow"]) == 0
    # the warm state carries rows across frames
    assert int(np.sum(t["final"]["warm"].partner != -9)) > 0
    hold_to_jax(jx["stress"], t, final_atol=STRESS_ATOL)
    # step 1 rebuilt the cache on both: its candidate lists are in use
    assert t["snaps"][1]["bp"].ok.sum() > 0


def test_spatial_agitated_pile_matches_jax_every_step(runs):
    """The agitated pile, 6 spatial steps: on every step the halo
    membership, candidate lists and warm rows equal to mgf_tpu's, x within
    1e-4 and v, omega within 1e-3 (the random velocities amplify the
    rounding of the two packages' different sum orders: 2.9e-5 after one
    step, 2.9e-4 at most in 6).  Dropping the halo rows' mass-splitting
    counts moves v by 0.25 on step 2."""
    _, port, jx = runs
    t = port["agitated"]
    assert all(int(m["num_contacts"]) > 500 for m in t["metrics"])
    hold_to_jax(jx["agitated"], t, final_atol=1e-3, snap_atol=(1e-4, 1e-3))

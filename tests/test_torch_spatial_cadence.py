"""The port's spatial step with the ``bp_every`` cache against the
rebuild-every-step run, against mgf_tpu's on the same numpy worlds
(mgf_tpu on 4 of conftest's virtual CPU devices, the port on 4 gloo ranks
on the CPU).

The test replays its namesake of tests/test_spatial.py (the cached
cadence against the rebuild-every-step run).  Beyond that, as in
test_torch_spatial.py: the shard, boundaries, halo and comm metrics and
the ``broadphase_rebuilt`` series exactly, each rank's step-1 halo
membership, candidate lists and warm partner gids exactly, per-row state
within 1e-5 after one step and within the JAX test's own tolerance (5e-3
for the warm-started stress config) after the last.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mgf_tpu.scenes import stress_scene as j_stress_scene  # noqa: E402

from test_torch_spatial import (  # noqa: E402
    hold_to_jax, jax_spatial, run_port, sorted_positions, spatial_spec,
)
from test_torch_spatial_stress import STRESS_ATOL, _dropped  # noqa: E402


@pytest.fixture(scope="module")
def runs():
    w, c = j_stress_scene(n_bodies=256, layers=3)
    c = c._replace(pallas_solver=False, n_sphere_rows=-1,
                   adapt_schedule=None)
    assert c.bp_every > 1 and c.stable_pairs
    w = _dropped(w)
    # halo 64 covers the whole 64-body shard: the cached build inflates
    # the halo band by each body's slack, which at this size spans most of
    # a slab (test_spatial.py's choice)
    every = spatial_spec(w, c._replace(bp_every=1, warm_match="search"),
                         halo=64, steps=8, snaps=(1,))
    cached = spatial_spec(w, c, halo=64, steps=8, snaps=(1,))
    specs = dict(every=every, cached=cached)
    port = dict(zip(specs, run_port(list(specs.values()), 4)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jx = {k: jax_spatial(s, 4) for k, s in specs.items()}
    return specs, port, jx


def test_spatial_bp_cadence_matches_every_step_rebuild(runs):
    """The staleness-gated cache reuses candidate lists (some steps not
    rebuilt), keeps drift excess at 0 and tracks the rebuild-every-step
    spatial trajectory; its rebuild series is mgf_tpu's."""
    _, port, jx = runs
    t2 = port["cached"]
    rebuilt = [bool(m["broadphase_rebuilt"]) for m in t2["metrics"]]
    assert 1 <= sum(rebuilt) < 8, rebuilt
    assert max(float(m["broadphase_cache_drift_excess"])
               for m in t2["metrics"]) == 0.0
    m = t2["metrics"][-1]
    assert int(m["spatial_stray"]) == 0 and int(m["halo_overflow"]) == 0
    np.testing.assert_allclose(sorted_positions(t2["final"]["bodies"]),
                               sorted_positions(port["every"]["final"][
                                   "bodies"]), atol=STRESS_ATOL)
    assert rebuilt == [bool(m["broadphase_rebuilt"])
                       for m in jx["cached"]["metrics"]]
    hold_to_jax(jx["cached"], t2, final_atol=STRESS_ATOL)
    hold_to_jax(jx["every"], port["every"], final_atol=STRESS_ATOL)

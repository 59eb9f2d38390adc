"""The port's all-gather sharded step against mgf_tpu's, on the same numpy
worlds: mgf_tpu on conftest's 8 virtual CPU devices, the port on 8 gloo
ranks on the CPU (spawned once for the module).

Each test replays a test of tests/test_sharded.py: its bars hold the
port's sharded step against the port's single-device step.  Beyond them
the port is held to mgf_tpu's sharded step: the padded shard exactly, the
pair, contact and overflow counts of every step exactly, per-row x, v and
omega within 1e-5 after one step and within 1e-4 after five.  The last
test runs the port's ``dryrun_multichip`` on 4 CPU ranks.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from mgf_tpu import parallel as j_parallel  # noqa: E402
from mgf_tpu.scenes import balls_scene as j_balls_scene  # noqa: E402

from test_torch_spatial import (  # noqa: E402
    body_rows, cpu_mesh, np_tree, port_cfg, port_single, port_world,
    run_port,
)

STEP1_ATOL = 1e-5
FINAL_ATOL = 1e-4
N_DEV = 8


def _spec(num, dropped):
    world, cfg = j_balls_scene(num=num, with_dropped=dropped)
    # the sharded solver is single-phase; match it on the single side
    cfg = cfg._replace(two_phase=False)
    return dict(kind="sharded", jworld=world, jcfg=cfg,
                world=port_world(world), cfg=port_cfg(cfg), steps=5,
                snaps=(1,))


def _jax_sharded(spec):
    mesh = cpu_mesh(N_DEV)
    w = j_parallel.shard_world(spec["jworld"], mesh)
    out = dict(shard0=np_tree(w.bodies), metrics=[], snaps={})
    f = j_parallel.make_sharded_step(spec["jcfg"], mesh)
    for i in range(spec["steps"]):
        w, m = f(w)
        out["metrics"].append(np_tree(m))
        if i + 1 in spec["snaps"]:
            out["snaps"][i + 1] = np_tree(w.bodies)
    out["final"] = np_tree(w.bodies)
    return out


@pytest.fixture(scope="module")
def runs():
    specs = dict(plain=_spec(4, False), padded=_spec(4, True))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        port = dict(zip(specs, run_port(list(specs.values()), N_DEV)))
        jx = {k: _jax_sharded(s) for k, s in specs.items()}
    return specs, port, jx


def _hold_to_jax(j, t):
    lj = jax.tree_util.tree_leaves(j["shard0"])
    lt = jax.tree_util.tree_leaves(t["shard0"]["bodies"])
    assert len(lj) == len(lt) > 0
    for a, b in zip(lj, lt):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for mj, mt in zip(j["metrics"], t["metrics"]):
        for k in ("broadphase_overflow", "num_pairs", "num_contacts"):
            assert int(mj[k]) == int(mt[k]), (k, mj[k], mt[k])
    np.testing.assert_allclose(body_rows(t["snaps"][1]["bodies"]),
                               body_rows(j["snaps"][1]), atol=STEP1_ATOL,
                               rtol=0)
    np.testing.assert_allclose(body_rows(t["final"]["bodies"]),
                               body_rows(j["final"]), atol=FINAL_ATOL,
                               rtol=0)


def test_sharded_matches_single_device(runs):
    specs, port, jx = runs
    t = port["plain"]
    ws, ms = port_single(specs["plain"], 5)
    b = t["final"]["bodies"]
    np.testing.assert_allclose(b.x.y, ws.bodies.x.y.numpy(), atol=1e-4)
    np.testing.assert_allclose(b.v.y, ws.bodies.v.y.numpy(), atol=1e-3)
    assert int(t["metrics"][-1]["num_contacts"]) == int(ms["num_contacts"])
    _hold_to_jax(jx["plain"], t)


def test_sharded_padding_matches_single_device(runs):
    """65 bodies on 8 ranks: the shard is padded to 72 with inert statics
    that do not perturb the real bodies and never move."""
    specs, port, jx = runs
    t = port["padded"]
    b = t["final"]["bodies"]
    assert b.x.y.shape == (72,)
    ws, ms = port_single(specs["padded"], 5)
    np.testing.assert_allclose(b.x.y[:65], ws.bodies.x.y.numpy(), atol=1e-4)
    assert np.all(b.x.y[65:] == 1.0e5)
    assert int(t["metrics"][-1]["num_contacts"]) == int(ms["num_contacts"])
    _hold_to_jax(jx["padded"], t)


def test_graft_entry_dryrun():
    from mgf_tpu_torch.entry import dryrun_multichip
    dryrun_multichip(4, device="cpu")

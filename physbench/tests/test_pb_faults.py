"""A run of each cell at a size a test can hold, on the CPU (the look for
a card skipped), sound and with its timed path broken underneath: the
comparison has to pass the sound run and fail each fault the cell can
have, and fail its control (the reference in bfloat16 in the program's
place).  The cells run on one card, so "the exchange between chips left
out" is not a fault they can have."""

import pytest
import torch

from physbench import run
from physbench.harness import compare, manifest

CELLS = [w["name"] for w in manifest.manifest()["workloads"]]
N_BODIES = 400


def _small(cell_name):
    """The cell's configuration, traffic and limits at ``N_BODIES``
    bodies, a short settle and one compared chunk."""
    from mgf_tpu_torch import scenes
    cell = manifest.cell(cell_name)
    conf = manifest.config(cell["config"])
    traffic = dict(manifest.traffic(cell["traffic"]))
    conf["scene"] = dict(conf["scene"], n_bodies=N_BODIES)
    sc = dict(conf["scene"])
    builder = getattr(scenes, sc.pop("builder"))
    _, cfg = builder(device="cpu", **sc)
    conf["engine"] = dict(conf["engine"], grid=dict(
        conf["engine"]["grid"], dim=list(cfg.grid.dim)),
        n_sphere_rows=cfg.n_sphere_rows)
    traffic.update(settle_steps=max(traffic["chunk"], 24), compare_chunks=1)
    return cell, conf, traffic, manifest.limits(cell_name)


def _seconds(traffic):
    """A window in which a second chunk (the compared one) starts on the
    CPU: the first chunk starts before any moment a sample is drawn at."""
    return 2.0 + 0.5 * traffic["chunk"] if traffic["chunk"] < 64 else 14.0


def _run(cell_name, hook=None):
    cell, conf, traffic, limits = _small(cell_name)
    seconds = _seconds(traffic)
    torch.manual_seed(0)
    return run.run_cell(cell, conf, traffic, limits, 2 ** 33 + 7, seconds,
                        False, torch.device("cpu"), 0.0, stepper_hook=hook,
                        log=lambda msg: None)


def _bodies(world, fn):
    return world._replace(bodies=fn(world.bodies))


def unchanged(st):
    """The step returns its state unchanged."""
    def call(world, scales):
        _, m = st.step_chunk(world, scales)
        return world, m
    return call


def half_left_out(st):
    """Half of the bodies are left out: they keep their state."""
    def call(world, scales):
        new, m = st.step_chunk(world, scales)
        n = new.bodies.n_bodies // 2
        keep = lambda a, b: torch.cat([b[:n], a[n:]]) if torch.is_tensor(
            b) and b.dim() >= 1 and b.shape[0] == 2 * n else b
        from mgf_tpu_torch.math3d import tree_map
        bodies = tree_map(keep, world.bodies, new.bodies)
        return new._replace(bodies=bodies), m
    return call


def altered(st):
    """One answer altered where it is produced: a body's velocity."""
    def call(world, scales):
        new, m = st.step_chunk(world, scales)
        v = new.bodies.v
        vx = v.x.clone()
        vx[N_BODIES // 3] += 0.5
        return new._replace(bodies=new.bodies._replace(
            v=v._replace(x=vx))), m
    return call


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"], res["checks"]
    assert res["checks"]["v_gap_median"]["value"] < \
        res["checks"]["v_gap_median"]["limit"]


@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault):
    res = _run(cell, fault)
    assert not res["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    """The reference in bfloat16, put in the program's place on the same
    compared chunk, fails the cell's limits."""
    cell_, conf, traffic, limits = _small(cell)
    res = run.run_cell(cell_, conf, traffic, limits, 2 ** 33 + 7,
                       _seconds(traffic), False,
                       torch.device("cpu"), 0.0, log=lambda msg: None,
                       control_dtype=torch.bfloat16)
    assert res["control"], "no compared chunk ran"
    ok, rows = compare.judge(res["control"], limits, conf, N_BODIES)
    assert not ok, rows

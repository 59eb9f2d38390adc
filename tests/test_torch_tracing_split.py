"""Tracing of the mixed pile's split solve (``world.step_tail``'s two
column blocks) on the CPU, where a stamp reads the host's clock:

* the sphere block closes ``solve_spheres`` and the capsule block
  ``solve_capsules``, once a step each, in that order, in place of
  ``solve``; ``tracing.summary``'s ``solver`` is their sum and
  ``sphere_block_solve`` / ``capsule_block_solve`` each one of them;
* the device counter ``capsule_rows`` equals a plain count of the valid
  rows in the capsule columns (those at and past ``n_sphere_rows``), which
  each step leaves in its warm rows (a valid row keeps its partner, every
  other one reads -9);
* the sphere pile's fused step stamps what it stamped before the split
  stamps existed, counts no capsule row, and its summary reads None for
  the three.
"""

import pytest

torch = pytest.importorskip("torch")

from mgf_tpu_torch import tracing  # noqa: E402
from mgf_tpu_torch import world as W  # noqa: E402
from mgf_tpu_torch.driver import make_chunk_step  # noqa: E402
from mgf_tpu_torch.math3d import Vec3  # noqa: E402
from mgf_tpu_torch.ops import stamp as stamp_op  # noqa: E402
from mgf_tpu_torch.scenes import stress_scene  # noqa: E402

CPU = "cpu"


@pytest.fixture(autouse=True)
def _tracing_off():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _pile(n=300, mixed=True):
    """A small pile pressed together, so that the first steps have
    contacts (capsules among them where ``mixed``)."""
    world, cfg = stress_scene(n, mixed=mixed, device=CPU)
    b = world.bodies
    y0 = b.x.y.min()
    x = Vec3(b.x.x, y0 + 0.75 * (b.x.y - y0), b.x.z)
    return world._replace(bodies=b._replace(x=x)), cfg


def _stamped_names(monkeypatch, world, cfg):
    """The stamps one step closes, by name, and the step's metrics."""
    name_of = {slot: key for key, slot in tracing._SLOT.items()}
    seen = []
    real = stamp_op.stamp

    def logged(buf, slot):
        seen.append(name_of[slot])
        real(buf, slot)

    with monkeypatch.context() as mp:
        mp.setattr(stamp_op, "stamp", logged)
        _, m = W.step(world, cfg)
    return seen, m


@pytest.mark.parametrize("warm_steps", [0, 1])
def test_split_solve_closes_both_blocks_in_order(monkeypatch, warm_steps):
    world, cfg = _pile()
    tracing.enable(CPU)
    for _ in range(warm_steps):
        world, _ = W.step(world, cfg)
    tracing.reset()
    seen, m = _stamped_names(monkeypatch, world, cfg)
    variant = "rebuild" if bool(m["broadphase_rebuilt"]) else "reuse"
    tail = [n for n in tracing.TAIL if n != "solve"]
    want = ([(n, None) for n in tracing.HEAD]
            + [(n, variant) for n in tail[:-1]]
            + [(n, variant) for n in tracing.SPLIT] + [(tail[-1], variant)])
    assert seen == want
    rec = tracing.record()
    assert rec["steps"] == 1
    assert rec["intervals"]["solve"]["count"] == 0
    assert all(rec["intervals"][n]["count"] == 1 for n in tracing.SPLIT)
    assert sum(v["ns"] for v in rec["intervals"].values()) == rec["span_ns"]
    s = tracing.summary(rec)
    ns = [rec["intervals"][n]["ns"] for n in tracing.SPLIT]
    assert s["sphere_block_solve"] == pytest.approx(1e-6 * ns[0])
    assert s["capsule_block_solve"] == pytest.approx(1e-6 * ns[1])
    assert s["solver"] == pytest.approx(s["sphere_block_solve"]
                                        + s["capsule_block_solve"])
    assert s["solver"] > 0


def test_capsule_rows_counts_the_capsule_columns():
    world, cfg = _pile()
    ns = cfg.n_sphere_rows
    assert 0 < ns < world.bodies.n_bodies
    C = 4
    tracing.enable(CPU)
    chunk = make_chunk_step(cfg._replace(adapt_schedule=None), light=True)
    plain, w = 0, world
    for _ in range(2):
        for _ in range(C):
            w, _ = W.step(w, cfg._replace(adapt_schedule=None,
                                          light_metrics=True))
            plain += int((w.warm.partner[:, ns:] != -9).sum())
    tracing.reset()
    w2 = world
    for _ in range(2):
        w2, _ = chunk(w2, torch.ones((C,)))
    rec = tracing.record()
    assert rec["steps"] == 2 * C
    assert plain > 0
    assert rec["capsule_rows"] == plain
    # the capsule rows are some of the step's valid rows, not all
    assert 0 < rec["capsule_rows"] < rec["counters"]["contacts"]
    assert tracing.summary(rec)["capsule_rows_per_step"] == plain / (2 * C)


def test_fused_step_stamps_and_counts_as_before(monkeypatch):
    world, cfg = _pile(mixed=False)
    assert cfg.fused_iso
    tracing.enable(CPU)
    world, _ = W.step(world, cfg)
    tracing.reset()
    seen, m = _stamped_names(monkeypatch, world, cfg)
    variant = "rebuild" if bool(m["broadphase_rebuilt"]) else "reuse"
    assert seen == ([(n, None) for n in tracing.HEAD]
                    + [(n, variant) for n in tracing.TAIL])
    rec = tracing.record()
    assert all(rec["intervals"][n]["count"] == 0 for n in tracing.SPLIT)
    assert rec["capsule_rows"] == 0 and rec["counters"]["contacts"] > 0
    s = tracing.summary(rec)
    assert s["solver"] == pytest.approx(
        1e-6 * rec["intervals"]["solve"]["ns"])
    assert (s["sphere_block_solve"], s["capsule_block_solve"],
            s["capsule_rows_per_step"]) == (None, None, None)

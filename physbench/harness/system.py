"""The system under test: the port (``mgf_tpu_torch``) built as a
configuration file states, and driven by the traffic mix's stepper.

Only this module and :mod:`physbench.harness.state` import the program.
"""

from __future__ import annotations

import torch


def _plain(v):
    """A config value as JSON has it (tuples as lists, groups as dicts)."""
    if hasattr(v, "_asdict"):
        return {k: _plain(x) for k, x in v._asdict().items()}
    if isinstance(v, tuple):
        return [_plain(x) for x in v]
    return v


def _set(cfg, changes: dict):
    """``cfg`` with the fields of ``changes`` set (a dict sets the fields of
    a nested group)."""
    return cfg._replace(**{
        k: _set(getattr(cfg, k), v) if isinstance(v, dict) else v
        for k, v in changes.items()})


def build_world(conf: dict, seed: int, device):
    """The configuration's scene from ``seed`` on ``device``: (world,
    WorldConfig).  The engine settings the builder returns, with the file's
    ``engine_set`` changes applied through ``WorldConfig``, have to equal
    the file's ``engine`` block in every field, or this raises."""
    from mgf_tpu_torch import scenes
    sc = dict(conf["scene"])
    builder = getattr(scenes, sc.pop("builder"))
    world, cfg = builder(seed=seed, device=device, **sc)
    cfg = _set(cfg, conf.get("engine_set", {}))
    got = _plain(cfg)
    want = conf["engine"]
    diff = sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k))
    if diff:
        raise RuntimeError(
            f"{conf['name']}: the program's settings differ from the "
            f"configuration file in {diff}: "
            + ", ".join(f"{k}={got.get(k)!r} (file {want.get(k)!r})"
                        for k in diff))
    return world, cfg


def stepper(cfg, chunk: int):
    """The window's entry: ``AdaptiveChunkStepper`` with light interior
    metrics, replaying CUDA graphs of the step on the card."""
    from mgf_tpu_torch.driver import AdaptiveChunkStepper
    return AdaptiveChunkStepper(cfg, chunk=chunk, light=True)


def schedule_of(st) -> tuple:
    """The (iters, inner) solver schedule the stepper's last chunk ran."""
    if st.hot_on:
        return tuple(st.hot.keywords["schedule"])
    cfg = st.run_chunk.cfg
    return (cfg.solver_iters, cfg.solver_inner)


def captured(st):
    """The stepper's ``graphs.CapturedStep`` (None before its first chunk
    or where the step runs eagerly)."""
    return st.run_chunk.captured


def _cache_at(world, count: int, slack=None):
    """A copy of ``world`` whose broadphase cache has stepped ``count``
    times (the cadence rebuilds when the count is a multiple of
    ``bp_every``) and, with ``slack``, gives every body that slack (a
    large one keeps the cache from going stale)."""
    bp = world.bp._replace(count=torch.full_like(world.bp.count, count))
    if slack is not None:
        bp = bp._replace(slack=torch.full_like(bp.slack, slack))
    return world._replace(bp=bp)


def warm_variants(st, world, period: int, scales):
    """Capture every graph variant a window can meet before it starts.
    ``graphs.CapturedStep`` keeps one graph per variant: the head with
    light or full metrics, the tail for rebuild or reuse x light or full
    x the solver schedule (one step a chunk: full metrics only).  For both
    schedules, chunks of two steps (one, where the chunk is one step) from
    edited copies of ``world``: a cache that rebuilds at the first step,
    one that reuses at both (given a slack no body outruns), one that
    reuses and then rebuilds at the cadence.  The stepper's own schedule
    state is untouched.  Returns the number of variants still without a
    graph."""
    cap = captured(st)
    if cap is None or not cap.graphs:
        return 0
    full = (st.run_chunk.cfg.solver_iters, st.run_chunk.cfg.solver_inner)
    hot = tuple(st.hot.keywords["schedule"])
    c = min(2, st.chunk)
    for sched in (full, hot):
        cap.run(_cache_at(world, 0), scales[:c], sched)
        cap.run(_cache_at(world, 1, 1e9), scales[:c], sched)
        cap.run(_cache_at(world, period - c + 1, 1e9), scales[:c], sched)
    expected = 2 + 8 if st.chunk > 1 else 1 + 4
    return expected - cap.n_graphs


def _counters():
    from mgf_tpu_torch.ops import (
        narrowphase, sequential_solve, solver_sweep, terrain,
    )
    return (("K1", solver_sweep, "LAUNCHES"), ("K2", narrowphase, "LAUNCHES"),
            ("K4", sequential_solve, "LAUNCHES"),
            ("K5", terrain, "LAUNCHES"))


def reset_launches():
    """Zero the program's kernel launch counters."""
    for _, mod, attr in _counters():
        setattr(mod, attr, 0)


def launch_counts() -> dict:
    """The program's kernel launch counters (replay-true)."""
    return {k: getattr(mod, attr) for k, mod, attr in _counters()}


def program_tracing(on: bool, device=None):
    """Turn the program's own tracing (its device stamps, counters and
    host spans) on for worlds on ``device``, or off.  Returns the tracing
    module."""
    from mgf_tpu_torch import tracing
    if on:
        tracing.enable(device)
    else:
        tracing.disable()
    return tracing


def program_record():
    """What the program's tracing recorded since its last reset:
    ``dict(record=tracing.record(), summary=tracing.summary(record))``
    (the record synchronises the device)."""
    from mgf_tpu_torch import tracing
    rec = tracing.record()
    return dict(record=rec, summary=tracing.summary(rec))

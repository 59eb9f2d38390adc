"""Host-side stepping drivers: chunked stepping and the host-adaptive solver
schedule (counterpart of ``mgf_tpu.driver``).

The JAX package runs a chunk of C steps as one jitted ``lax.scan``.  Here
a chunk on the card replays CUDA graphs of the step
(:class:`graphs.CapturedStep`): per step one replay of the step's head,
one host read of ``need`` where the step keeps a broadphase cache, and one
replay of the tail for that value.  A CPU world runs the same bookkeeping
with every segment eager.  ``capture=False`` runs the chunk as a Python
loop over ``step``, and so do the paths that ``graphs.capture_refusal``
keeps eager (the capsule shape mode, the mesh terrain cull, the flat
solvers, ``profile_stage`` and debug mode).  With ``light=True`` the
interior steps skip the heavy observability metrics and the last step of
every chunk reports them in full, so the quality guards stay visible once
per chunk.

:class:`AdaptiveChunkStepper` picks the solver schedule on the host from
``warm_hit_frac``, read two chunks late from a copy taken when its chunk
ended, with the same patience rule as the JAX package.  With ``tracing``
on it counts the steps run on each schedule, and its host spans
``driver.chunk`` (a whole :meth:`AdaptiveChunkStepper.step_chunk`) and
``driver.schedule_read`` (the read of a lagged ``warm_hit_frac``) hold
the chunk's spans.
"""

from __future__ import annotations

import functools

import torch

from mgf_tpu_torch import tracing
from mgf_tpu_torch.graphs import CapturedStep, capture_refusal, span_or_null
from mgf_tpu_torch.world import WorldConfig, step

__all__ = ["make_chunk_step", "AdaptiveChunkStepper"]


def _stack_metrics(ms, device):
    return {k: torch.stack([torch.as_tensor(m[k], device=device)
                            for m in ms]) for k in ms[0]}


class _Chunks:
    """The chunk function of :func:`make_chunk_step`:
    ``(world, scales, schedule=None) -> (world, metrics)``; ``schedule``
    (iters, inner) overrides the config's solver schedule.  It keeps one
    :class:`CapturedStep` for the worlds it accepts; ``capture`` (as in
    :func:`make_chunk_step`) may be changed between chunks."""

    def __init__(self, cfg: WorldConfig, light: bool, capture):
        self.cfg = cfg
        self.light = light
        self.capture = capture
        self.captured = None

    def __call__(self, world, scales, schedule=None):
        cfg = self.cfg
        why = capture_refusal(cfg)
        on_card = world.bodies.x.x.device.type == "cuda"
        if self.capture and (why or not on_card):
            raise ValueError(f"capture=True: "
                             f"{why or 'a CPU world runs eagerly'}")
        if self.capture is False or why:
            if schedule is not None:
                cfg = cfg._replace(solver_iters=int(schedule[0]),
                                   solver_inner=int(schedule[1]))
            return self._loop(cfg, world, scales)
        C = scales.shape[0]
        if self.captured is None or not self.captured.accepts(world, C):
            self.captured = None        # free the old graphs first
            self.captured = CapturedStep(cfg, world, C, light=self.light)
        return self.captured.run(world, scales, schedule)

    def _loop(self, cfg, world, scales):
        full_cfg = cfg._replace(light_metrics=False)
        light_cfg = cfg._replace(light_metrics=True)
        C = scales.shape[0]
        ms = []
        for i in range(C):
            c = light_cfg if (self.light and i < C - 1) else (
                full_cfg if self.light else cfg)
            b = world.bodies
            world = world._replace(
                bodies=b._replace(force=b.force * scales[i]))
            world, m = step(world, c)
            ms.append(m)
        return world, _stack_metrics(ms, scales.device)


def make_chunk_step(cfg: WorldConfig, light: bool = False, capture=None):
    """A ``(world, scales) -> (world, metrics)`` function running one
    ``step`` per entry of ``scales`` (a (C,) per-step force nonce tensor;
    pass ones for plain stepping).  Metrics come back stacked (C,) per
    key; the physics is identical to C separate calls.

    ``capture``: None replays CUDA graphs of the step on a card world
    (``graphs.CapturedStep``) and runs its bookkeeping eagerly on a CPU
    world, except on the paths ``graphs.capture_refusal`` keeps eager;
    True insists on graphs (a CPU world or a refused path raises); False
    runs the Python loop over ``step``."""
    return _Chunks(cfg, light, capture)


class AdaptiveChunkStepper:
    """Chunked stepping with the solver schedule selected by the host.

    ``cfg.adapt_schedule = (thr, it2, in2)``: full ``solver_iters x
    solver_inner`` while the contact set is in flux, ``it2 x in2`` once
    ``warm_hit_frac >= thr``; the choice lags two chunks.  Disengagement
    is immediate on the first lagged read below the threshold; engagement
    needs ``patience`` consecutive reads at or above it.  Both schedules
    share one chunk function (one set of static buffers and graphs);
    ``capture`` as in :func:`make_chunk_step`.
    """

    def __init__(self, cfg: WorldConfig, chunk: int = 16,
                 patience: int = 2, light: bool = False, capture=None):
        if cfg.adapt_schedule is None:
            raise ValueError("cfg.adapt_schedule is None — use "
                             "make_chunk_step directly")
        thr, it2, in2 = cfg.adapt_schedule
        self.thr = float(thr)
        self.chunk = int(chunk)
        self.patience = int(patience)
        base = cfg._replace(adapt_schedule=None)
        self.run_chunk = make_chunk_step(base, light=light, capture=capture)
        self.full = self.run_chunk
        self.hot = functools.partial(self.run_chunk,
                                     schedule=(int(it2), int(in2)))
        self.hot_on = False
        self._streak = 0
        self._pending = []      # warm_hit_frac device scalars, oldest first

    def _drain_one(self):
        frac = float(self._pending.pop(0))
        if frac >= self.thr:
            self._streak += 1
            if self._streak >= self.patience:
                self.hot_on = True
        else:
            self._streak = 0
            self.hot_on = False

    def step_chunk(self, world, scales=None):
        """Run one chunk; returns (world, stacked metrics).  The schedule
        used was decided from the chunk-before-last's metrics."""
        span = span_or_null()
        with span("driver.chunk"):
            if scales is None:
                scales = torch.ones((self.chunk,), dtype=torch.float32,
                                    device=world.bodies.x.x.device)
            while len(self._pending) >= 2:
                with span("driver.schedule_read"):
                    self._drain_one()
            f = self.hot if self.hot_on else self.full
            world, m = f(world, scales)
            # the metrics are the chunk's own copy: no later chunk writes
            # them
            self._pending.append(m["warm_hit_frac"][-1])
        if tracing.ON:
            cfg = self.run_chunk.cfg
            sched = (self.hot.keywords["schedule"] if self.hot_on
                     else (cfg.solver_iters, cfg.solver_inner))
            tracing.count_schedule(*sched, scales.shape[0], self.hot_on)
        return world, m

    def run(self, world, n_steps, scales=None):
        """Step ``n_steps`` (rounded up to whole chunks); returns
        (world, last metrics dict with per-key last-step values)."""
        n_chunks = -(-int(n_steps) // self.chunk)
        m = None
        for k in range(n_chunks):
            sc = (scales[k] if scales is not None else None)
            world, m = self.step_chunk(world, sc)
        return world, {k: v[-1] for k, v in m.items()}

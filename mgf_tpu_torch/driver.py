"""Host-side stepping drivers: chunked stepping and the host-adaptive solver
schedule (counterpart of ``mgf_tpu.driver``).

A chunk of C steps is a Python loop over ``step`` (the JAX package scans
it inside one jitted call).  With ``light=True`` the interior steps skip
the heavy observability metrics and the last step of every chunk reports
them in full, so the quality guards stay visible once per chunk.

:class:`AdaptiveChunkStepper` picks the solver schedule on the host from
``warm_hit_frac``, read two chunks late, with the same patience rule as
the JAX package.
"""

from __future__ import annotations

import torch

from mgf_tpu_torch.world import WorldConfig, step

__all__ = ["make_chunk_step", "AdaptiveChunkStepper"]


def _stack_metrics(ms, device):
    return {k: torch.stack([torch.as_tensor(m[k], device=device)
                            for m in ms]) for k in ms[0]}


def make_chunk_step(cfg: WorldConfig, light: bool = False):
    """A ``(world, scales) -> (world, metrics)`` function running one
    ``step`` per entry of ``scales`` (a (C,) per-step force nonce tensor;
    pass ones for plain stepping).  Metrics come back stacked (C,) per
    key; the physics is identical to C separate calls."""
    full_cfg = cfg._replace(light_metrics=False)
    light_cfg = cfg._replace(light_metrics=True)

    def run(world, scales):
        C = scales.shape[0]
        ms = []
        for i in range(C):
            c = light_cfg if (light and i < C - 1) else (
                full_cfg if light else cfg)
            b = world.bodies
            world = world._replace(bodies=b._replace(force=b.force * scales[i]))
            world, m = step(world, c)
            ms.append(m)
        return world, _stack_metrics(ms, scales.device)

    return run


class AdaptiveChunkStepper:
    """Chunked stepping with the solver schedule selected by the host.

    ``cfg.adapt_schedule = (thr, it2, in2)``: full ``solver_iters x
    solver_inner`` while the contact set is in flux, ``it2 x in2`` once
    ``warm_hit_frac >= thr``; the choice lags two chunks.  Disengagement
    is immediate on the first lagged read below the threshold; engagement
    needs ``patience`` consecutive reads at or above it.
    """

    def __init__(self, cfg: WorldConfig, chunk: int = 16,
                 patience: int = 2, light: bool = False):
        if cfg.adapt_schedule is None:
            raise ValueError("cfg.adapt_schedule is None — use "
                             "make_chunk_step directly")
        thr, it2, in2 = cfg.adapt_schedule
        self.thr = float(thr)
        self.chunk = int(chunk)
        self.patience = int(patience)
        base = cfg._replace(adapt_schedule=None)
        self.full = make_chunk_step(base, light=light)
        self.hot = make_chunk_step(base._replace(solver_iters=int(it2),
                                                 solver_inner=int(in2)),
                                   light=light)
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
        if scales is None:
            scales = torch.ones((self.chunk,), dtype=torch.float32,
                                device=world.bodies.x.x.device)
        while len(self._pending) >= 2:
            self._drain_one()
        f = self.hot if self.hot_on else self.full
        world, m = f(world, scales)
        self._pending.append(m["warm_hit_frac"][-1])
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

"""Metrics and timing helpers (counterpart of ``mgf_tpu.utils.metrics``).

The reference's only instrumentation is the demos' per-step wall-clock
print (balls.rs:107-112).  Every step returns a metrics dict of device
tensors; :class:`MetricsLog` accumulates them on the host and
:class:`StepTimer` times steps, synchronising the card before it reads
the clock, with an optional ``torch.profiler`` chrome trace.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch


def _item(v):
    return v.item() if isinstance(v, torch.Tensor) else np.asarray(v).item()


def _leaves(tree):
    """The tensor leaves of a tree of NamedTuples, tuples, lists and
    dicts."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [t for part in tree for t in _leaves(part)]
    return []


class MetricsLog:
    """Accumulates per-step metrics dicts on the host (one ``.item()`` per
    value, so one device read each)."""

    def __init__(self):
        self.rows = []

    def append(self, metrics):
        self.rows.append({k: _item(v) for k, v in metrics.items()})

    def summary(self):
        if not self.rows:
            return {}
        keys = self.rows[0].keys()
        return {k: float(np.mean([r[k] for r in self.rows])) for k in keys}


class StepTimer:
    """Wall-clock step timing, mirroring balls.rs:107-112.

    with StepTimer() as t:
        for _ in range(n): world, m = step(world)
        t.sync(world)
    print(t.ms_per_step(n))

    ``trace_dir`` records a ``torch.profiler`` trace of the block (the
    card's kernels too, where there is one) and writes it there as
    ``trace.json`` (chrome trace format).
    """

    def __init__(self, trace_dir: Optional[str] = None):
        self.trace_dir = trace_dir
        self._t0 = None
        self._elapsed = None

    def __enter__(self):
        if self.trace_dir:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._trace = torch.profiler.profile(activities=acts)
            self._trace.__enter__()
        self._t0 = time.perf_counter()
        return self

    def sync(self, tree):
        """Wait for the work behind ``tree``'s tensors on their CUDA
        devices (no-op for CPU tensors)."""
        for dev in {t.device for t in _leaves(tree) if t.is_cuda}:
            torch.cuda.synchronize(dev)

    def __exit__(self, *exc):
        self._elapsed = time.perf_counter() - self._t0
        if self.trace_dir:
            self._trace.__exit__(*exc)
            os.makedirs(self.trace_dir, exist_ok=True)
            self._trace.export_chrome_trace(
                os.path.join(self.trace_dir, "trace.json"))
        return False

    def ms_per_step(self, n_steps: int) -> float:
        return self._elapsed / max(n_steps, 1) * 1000.0

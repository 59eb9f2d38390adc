"""Host spans, and the reading of a ``torch.profiler`` trace of the device.

Spans are the benchmark's own: named host intervals around its calls into
the program (scene, settle, capture, chunk call, positions copy,
reference), kept in memory and written out once the run ends.  Inside a
traced window each span is also a profiler range, so that the idle gaps
of the device can be labelled by what the host was doing.
"""

from __future__ import annotations

import contextlib
import json
import time

import torch


class Spans:
    """Named host intervals, in memory; ``profiling`` mirrors each span
    into the profiler as a ``record_function`` range."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.rows = []          # (name, start s, end s) from t0
        self.profiling = False

    @contextlib.contextmanager
    def span(self, name: str):
        start = time.perf_counter()
        rf = (torch.profiler.record_function(f"span:{name}")
              if self.profiling else contextlib.nullcontext())
        with rf:
            try:
                yield
            finally:
                self.rows.append((name, start - self.t0,
                                  time.perf_counter() - self.t0))

    def seconds(self, name: str) -> float:
        return sum(e - s for n, s, e in self.rows if n == name)

    def write(self, path):
        with open(path, "w") as f:
            json.dump([dict(name=n, start_s=s, end_s=e)
                       for n, s, e in self.rows], f)


def _union(intervals):
    """The merged intervals of a list of (start, end)."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def read_trace(prof, window_s: float, steps: int):
    """What the traced window shows: the device operations (kernels,
    copies, sets) with their times, the union of their intervals, the
    longest idle gaps labelled by the innermost benchmark span open at the
    gap's start, and the time by operation name.  Times in seconds.
    Returns None when the trace holds no device operation."""
    dev, spans = [], []
    for e in prof.events():
        tr = e.time_range
        if e.name.startswith("span:"):
            # a span is a host range, and the profiler mirrors it on the
            # device as an annotation: neither is a device operation
            if getattr(e, "device_type", None) != \
                    torch.autograd.DeviceType.CUDA:
                spans.append((tr.start, tr.end, e.name[5:]))
        elif getattr(e, "device_type", None) == \
                torch.autograd.DeviceType.CUDA and \
                not getattr(e, "is_user_annotation", False):
            dev.append((tr.start, tr.end, e.name))
    if not dev:
        return None
    union = _union([(s, e) for s, e, _ in dev])
    busy_us = sum(e - s for s, e in union)
    by_name = {}
    for s, e, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
    gaps = []
    for (_, e0), (s1, _) in zip(union, union[1:]):
        label = "no span"
        open_ = [sp for sp in spans if sp[0] <= e0 < sp[1]]
        if open_:
            label = min(open_, key=lambda sp: sp[1] - sp[0])[2]
        gaps.append((s1 - e0, label))
    gaps.sort(reverse=True)
    return dict(
        n_ops=len(dev), busy_s=busy_us * 1e-6, window_s=window_s,
        steps=steps, by_name=by_name,
        top_ops=[(name[:120], t) for name, t in
                 sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
        idle_gaps=[[label, g * 1e-6] for g, label in gaps[:10]])

"""Tracing inside the port: the step's stages timed on the device, host
spans around the chunk driver's calls, and counters of the work done.

Off by default.  Off, nothing is recorded, no kernel is launched, no tensor
is allocated, and every CUDA graph captures what it captures without this
module: each call site tests :data:`ON` (and a span site also whether a
``torch.profiler`` session records) before calling in here.  The switch is
:func:`enable`, :func:`disable`, :func:`reset` and :func:`record`.

**Device stamps.**  :func:`stamp` closes a named interval of the step with
a one-thread kernel (``ops/stamp.py``) on the current stream, so a graph
capture records it and every replay stamps again; the clock is the
card's.  The step's intervals, each named after the stamp that closes it
(those that are also ``profile_stage`` checkpoints sit at them):

    head  step_gap | integrate | bounds
    tail  need_gap | pairs | narrow | terrain | rows | constraints | warm
          | solve | finish

The mixed pile's split solve (``world.step_tail``'s two column blocks)
closes ``solve_spheres`` after its sphere block and ``solve_capsules``
after its capsule block in place of ``solve`` (:data:`SPLIT`); every other
step closes the intervals above and no other.

``step_gap`` and ``need_gap`` close at the head's and the tail's first
node, so they hold the device's idle time before each (the host's loop,
its read of ``need``) and nothing else.  ``finish`` closes at the step's
end, after ``graphs.CapturedStep`` has committed it.  The tail's intervals
are kept apart for rebuild and reuse tails (the variant is fixed when the
tail runs).  ``CapturedStep.run`` stamps its own work outside the graphs:
``call_gap`` closes at its start (the caller's time since the previous
chunk), ``chunk_in`` after the world's load and the nonce copy,
``chunk_out`` after the metric rows and the world's copy.  Consecutive
intervals tile the time from the first stamp to the last, so their sum is
the stamped span.  Stamps are kept for the device tracing was enabled
for: on the CPU they read ``time.perf_counter_ns`` into host memory.
Graphs captured while tracing is on are other graph variants than those
captured while it is off.

**Counters**, on the device, in the step's tail (light steps too):
``pairs_tested`` (the sum of the candidate rows' ``pair_ok``, which the
metric ``num_pairs`` counts on full steps) and ``contacts`` (the valid
constraint rows, ``num_contacts``); on the split solve also
``capsule_rows`` (the valid rows in the capsule columns, those at and past
``n_sphere_rows``), kept apart from the two (:func:`count_capsule_rows`,
``record()["capsule_rows"]``).  On the host,
``AdaptiveChunkStepper.step_chunk`` counts the steps run on each solver
schedule and on the hot one.

**Spans**: ``driver.chunk``, ``driver.schedule_read``, ``graphs.load``,
``graphs.replay_head``, ``graphs.need_read``, ``graphs.replay_tail``,
``graphs.snapshot`` and ``graphs.capture``, each kept as (name, start ns,
end ns, parent index) on ``time.perf_counter_ns``.  While a
``torch.profiler`` session records, each span is also a
``record_function`` range named ``span:<name>`` (whether tracing is on or
not), so that a trace's idle gaps can be labelled by what the host was
doing.

:func:`record` reads it all (one device synchronisation);
:func:`summary` turns a record into the stage table a step.
"""

from __future__ import annotations

import time

import torch
from torch.autograd import profiler as _profiler

from mgf_tpu_torch.ops import stamp as _stamp

__all__ = ["ON", "enable", "disable", "reset", "record", "summary", "stamp",
           "count", "count_capsule_rows", "count_schedule", "span", "HEAD",
           "TAIL", "SPLIT", "CHUNK"]

ON = False

HEAD = ("step_gap", "integrate", "bounds")
TAIL = ("need_gap", "pairs", "narrow", "terrain", "rows", "constraints",
        "warm", "solve", "finish")
SPLIT = ("solve_spheres", "solve_capsules")
CHUNK = ("call_gap", "chunk_in", "chunk_out")
VARIANTS = ("rebuild", "reuse")
COUNTERS = ("pairs_tested", "contacts")

# (interval, tail variant or None) -> slot of the stamp buffer
_SLOT = {}
for _n in CHUNK + HEAD:
    _SLOT[_n, None] = len(_SLOT)
for _v in VARIANTS:
    for _n in TAIL + SPLIT:
        _SLOT[_n, _v] = len(_SLOT)

_buf = None       # the stamp buffer (int64, ``ops/stamp.py``'s layout)
_counters = None  # COUNTERS, then capsule_rows, int64, on the same device
_retired = []     # buffers of an earlier device: captured graphs may still
                  # write into them, so they are never freed
_spans = []       # [name, start ns, end ns or None, parent index or None]
_open = []        # indices of the spans open now, innermost last
_generation = 0   # bumped by reset: spans opened before it are not kept
_schedules = {}   # "iters x inner" -> steps
_hot_steps = 0


def enable(device=None) -> None:
    """Turn tracing on for worlds on ``device`` (default: the current CUDA
    card where there is one, else the CPU), allocating its buffers when
    the device is new.  Call it before the graphs are captured: a graph
    captured while tracing was off holds no stamps."""
    global ON, _buf, _counters
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if _buf is None or _buf.device != device:
        if _buf is not None:
            _retired.append((_buf, _counters))
        _buf = torch.zeros((_stamp.buffer_size(len(_SLOT)),),
                           dtype=torch.int64, device=device)
        _counters = torch.zeros((len(COUNTERS) + 1,), dtype=torch.int64,
                                device=device)
    ON = True


def disable() -> None:
    """Turn tracing off; what was recorded stays for :func:`record`."""
    global ON
    ON = False


def reset() -> None:
    """Forget everything recorded.  The device buffers are zeroed in place
    (captured graphs keep writing into them); the first stamp after a
    reset only opens an interval."""
    global _generation, _hot_steps
    if _buf is not None:
        _buf.zero_()
        _counters.zero_()
    _spans.clear()
    _open.clear()
    _generation += 1
    _schedules.clear()
    _hot_steps = 0


def stamp(name: str, device, rebuild=None) -> None:
    """Close interval ``name`` of the step on ``device``'s stream (a
    tensor's device, index included); a tail's interval names its variant
    by ``rebuild`` (a Python bool)."""
    if _buf is not None and device == _buf.device:
        variant = None if rebuild is None else VARIANTS[0 if rebuild else 1]
        _stamp.stamp(_buf, _SLOT[name, variant])


def count(device, pair_ok, rc_valid) -> None:
    """Add a step's tested pairs (``pair_ok``) and valid constraint rows
    (``rc_valid``) to the counters, on the device."""
    if _buf is not None and device == _buf.device:
        _counters[0:1].add_(torch.sum(pair_ok))
        _counters[1:2].add_(torch.sum(rc_valid))


def count_capsule_rows(device, rc_valid) -> None:
    """Add a split step's valid constraint rows in its capsule columns
    (``rc_valid`` sliced to them) to the ``capsule_rows`` counter, on the
    device."""
    if _buf is not None and device == _buf.device:
        _counters[-1:].add_(torch.sum(rc_valid))


def count_schedule(iters: int, inner: int, steps: int, hot: bool) -> None:
    """Count ``steps`` steps run on the (iters, inner) solver schedule,
    ``hot`` where it is the adaptive schedule's hot one."""
    global _hot_steps
    key = f"{int(iters)}x{int(inner)}"
    _schedules[key] = _schedules.get(key, 0) + int(steps)
    if hot:
        _hot_steps += int(steps)


class span:
    """A host span (a context manager): kept while tracing is on, and a
    ``record_function`` range ``span:<name>`` while a profiler records."""

    __slots__ = ("name", "_rf", "_i", "_gen")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._rf = None
        if _profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function("span:" + self.name)
            self._rf.__enter__()
        self._i = None
        if ON:
            self._i, self._gen = len(_spans), _generation
            _spans.append([self.name, time.perf_counter_ns(), None,
                           _open[-1] if _open else None])
            _open.append(self._i)
        return self

    def __exit__(self, *exc):
        if self._i is not None and self._gen == _generation:
            _spans[self._i][2] = time.perf_counter_ns()
            _open.remove(self._i)
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def record() -> dict:
    """What was recorded since the last :func:`reset` (synchronises the
    device): the stamped intervals, the counters, the schedules and the
    spans.

    ``intervals``: name -> {"ns", "count"} over every variant; ``tails``:
    "rebuild" / "reuse" -> the tail's intervals of that variant;
    ``span_ns``: the first stamp to the last; ``steps``: the stamped steps
    (``finish``'s count); ``capsule_rows``: the split solve's counter;
    ``spans``: [name, start ns, end ns (None while open), index of the
    parent span or None], parents first."""
    intervals = {n: {"ns": 0, "count": 0}
                 for n in CHUNK + HEAD + TAIL + SPLIT}
    tails = {v: {n: {"ns": 0, "count": 0} for n in TAIL + SPLIT}
             for v in VARIANTS}
    counters = dict.fromkeys(COUNTERS, 0)
    capsule_rows = 0
    span_ns = 0
    if _buf is not None:
        s = _buf.tolist()
        for (name, variant), slot in _SLOT.items():
            ns, k = s[2 + 2 * slot], s[3 + 2 * slot]
            intervals[name]["ns"] += ns
            intervals[name]["count"] += k
            if variant is not None:
                tails[variant][name] = {"ns": ns, "count": k}
        span_ns = s[0] - s[1] if s[0] else 0
        *counted, capsule_rows = _counters.tolist()
        counters = dict(zip(COUNTERS, counted))
    dev = None if _buf is None else _buf.device
    return dict(
        clock=None if dev is None else (
            "globaltimer" if dev.type == "cuda" else "perf_counter_ns"),
        device=None if dev is None else str(dev),
        span_ns=span_ns, steps=intervals["finish"]["count"],
        intervals=intervals, tails=tails, counters=counters,
        capsule_rows=capsule_rows, schedules=dict(_schedules),
        hot_steps=_hot_steps,
        spans=[list(sp) for sp in _spans])


def _ns(table: dict, names) -> int:
    # a record written without the split stamps has no SPLIT intervals
    return sum(table[n]["ns"] for n in names if n in table)


def summary(rec: dict) -> dict:
    """The stage table a step of a :func:`record` (ms a step unless named;
    None where the record has nothing to divide): the device time of each
    layer, the rebuild step, the host's and the device's wait on
    ``need``, the idle share, the schedule and the counters.  The split
    solve's blocks and ``capsule_rows_per_step`` are None where no stamped
    step ran the split solve."""
    iv, steps = rec["intervals"], rec["steps"]
    ms = (lambda names: 1e-6 * _ns(iv, names) / steps) if steps else (
        lambda names: None)
    split = steps and iv.get(SPLIT[1], {}).get("count", 0) > 0
    rebuilds = rec["tails"]["rebuild"]["finish"]["count"]
    need_read = sum(e - s for name, s, e, _ in rec["spans"]
                    if name == "graphs.need_read" and e is not None)
    sched_steps = sum(rec["schedules"].values())
    pairs = rec["counters"]["pairs_tested"]
    return dict(
        steps=steps,
        stages={n: ms([n]) for n in CHUNK + HEAD + TAIL + SPLIT},
        broadphase=ms(["bounds", "pairs"]),
        narrowphase=ms(["narrow", "terrain"]),
        constraints=ms(["rows", "constraints", "warm"]),
        solver=ms(["solve", *SPLIT]),
        sphere_block_solve=ms([SPLIT[0]]) if split else None,
        capsule_block_solve=ms([SPLIT[1]]) if split else None,
        commit=ms(["finish"]),
        rebuild_step=(1e-6 * (_ns(iv, ["integrate", "bounds"]) / steps
                              + _ns(rec["tails"]["rebuild"],
                                    TAIL[1:] + SPLIT)
                              / rebuilds) if steps and rebuilds else None),
        need_wait=1e-6 * need_read / steps if steps else None,
        need_gap=ms(["need_gap"]),
        idle_pct=(100.0 * _ns(iv, ["need_gap", "step_gap"]) / rec["span_ns"]
                  if rec["span_ns"] else None),
        unassigned_pct=(100.0 * (rec["span_ns"] - _ns(iv, iv))
                        / rec["span_ns"] if rec["span_ns"] else None),
        hot_schedule_pct=(100.0 * rec["hot_steps"] / sched_steps
                          if sched_steps else None),
        pairs_tested_per_step=pairs / steps if steps else None,
        contacts_per_pair_pct=(100.0 * rec["counters"]["contacts"] / pairs
                               if pairs else None),
        capsule_rows_per_step=(rec["capsule_rows"] / steps if split
                               else None))

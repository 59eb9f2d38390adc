"""CUDA-graph capture and replay of the physics step: the port's
counterpart of what ``jax.jit`` does for ``mgf_tpu/driver.py``.

The JAX package runs a chunk of C steps as one compiled ``lax.scan``, and
the step's two branches on ``need`` (rebuild or reuse the broadphase
cache; keyed or positional warm matching) are device-side ``lax.cond``s.
Here the step is split at its one host read (:func:`world.step_head`, then
``bool(need)``, then :func:`world.step_tail`), and each segment is a CUDA
graph that is captured once and replayed.  One step of a chunk is

    replay the head graph -> read ``need`` -> replay the tail graph for it

A step that keeps no broadphase cache has no host read: its head and tail
are one graph.

:class:`CapturedStep` holds the world in static buffers (every tensor of
``bodies``, ``bp`` and ``warm``, laid out in one flat buffer per dtype, so
that the world a chunk returns is one copy per dtype), a (C,) force-nonce
buffer, a (C,) metric row per key and a device-side step index.  The head
graph reads ``nonce[index]``; each tail graph ends by copying the new state
into the static buffers, writing its metrics into row ``index`` and
advancing the index, so a chunk collects its metrics with no per-step host
work.  A graph is captured lazily, for each variant a chunk meets: the
head for light or full metrics, the tail for rebuild or reuse x light or
full x the solver schedule.  The first use of a variant runs it eagerly
on a side stream (the warm-up ``torch.cuda.graph`` asks for; it also
builds and loads the CUDA kernels K1 and K2 before any capture), then
captures it.  The warm-up of a tail is that step's own work, so the
kernel launches it makes count once; a capture records its launches
(``ops.launches``) and every replay counts them again.

Captures run in the "global" error mode, so a synchronisation or a copy
from host memory left in a segment fails the capture, and the error names
the operation.  Nothing falls back to eager stepping.

Memory: each graph has a pool of its own (``torch.cuda.graph``'s default).
The head's outputs, which the tail graphs read, live in the head graph's
pool, where no other graph allocates.  :attr:`CapturedStep.graph_bytes`
sums the device memory reserved by the captures.

On a CPU world the same bookkeeping runs with every segment eager: the
CPU tests hold it against the functional chunk of ``driver.py``.

With ``tracing`` on, the graphs carry the step's device stamps (graphs
captured with tracing on and off are separate variants), :meth:`run`
stamps its own work outside them, and the host spans ``graphs.load``,
``graphs.replay_head``, ``graphs.need_read``, ``graphs.replay_tail`` (on a
step with no host read, ``graphs.replay_step``), ``graphs.snapshot`` and
``graphs.capture`` time the host's side of a chunk.
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.autograd import profiler as _profiler

from mgf_tpu_torch import tracing
from mgf_tpu_torch import world as W
from mgf_tpu_torch.math3d import tree_map
from mgf_tpu_torch.ops import launches

__all__ = ["CapturedStep", "capture_refusal", "span_or_null"]

_ALIGN = 64   # elements: each static tensor starts 256-byte aligned


def span_or_null():
    """``tracing.span`` while tracing is on or a profiler records, else a
    context of the same call that does nothing: a span site tests this
    once per chunk."""
    return (tracing.span if tracing.ON or _profiler._is_profiler_enabled
            else contextlib.nullcontext)


def capture_refusal(cfg: W.WorldConfig):
    """Why a step of ``cfg`` cannot be captured, or None.  Paths with a
    host read of their own inside the step stay eager, as do those this
    port has not moved to graphs yet (the capsules demo, the mesh terrain
    cull, the flat solvers)."""
    if cfg.profile_stage:
        return "profile_stage stops the step early and runs eagerly"
    if W.DEBUG_NANS:
        return "debug mode checks every step's output on the host"
    if cfg.adapt_schedule is not None:
        return ("adapt_schedule reads warm_hit_frac inside the step "
                "(AdaptiveChunkStepper picks the schedule on the host)")
    if cfg.solver != "rows":
        return f"the flat {cfg.solver!r} solver steps eagerly"
    if cfg.shape_mode == "capsules":
        return "the capsule shape mode steps eagerly"
    if cfg.terrain_bp == "grid":
        return "the mesh terrain cull (terrain_bp='grid') steps eagerly"
    return None


def _leaves(trees):
    """The tensors of a tuple of NamedTuple trees, in order (None fields
    have none)."""
    out = []
    for t in trees:
        tree_map(out.append, t)
    return out


def _fill(trees, leaves):
    """``trees`` with its tensors replaced by ``leaves``, in order."""
    it = iter(leaves)
    return tuple(tree_map(lambda _: next(it), t) for t in trees)


class _Flat:
    """Tensors laid out in one flat buffer per dtype; ``views`` are the
    tensors, in the order given."""

    def __init__(self, like, device):
        self._layout = []
        size = {}
        for t in like:
            off = size.get(t.dtype, 0)
            self._layout.append((t.dtype, off, t.numel(), tuple(t.shape)))
            size[t.dtype] = off + -(-t.numel() // _ALIGN) * _ALIGN
        self.bufs = {d: torch.empty((n,), dtype=d, device=device)
                     for d, n in size.items()}
        self.views = self.views_of(self.bufs)

    def views_of(self, bufs):
        """The tensors laid out in ``bufs`` (``bufs`` or a copy of it)."""
        return [bufs[d][o:o + n].view(s) for d, o, n, s in self._layout]

    def owns(self, t) -> bool:
        ptr = t.untyped_storage().data_ptr()
        return any(ptr == b.untyped_storage().data_ptr()
                   for b in self.bufs.values())


def _same_shapes(a, b) -> bool:
    """The same tree of NamedTuples, with tensors of the same shape, dtype
    and device at its leaves."""
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, tuple):
        return type(a) is type(b) and len(a) == len(b) and all(
            _same_shapes(x, y) for x, y in zip(a, b))
    return (isinstance(a, torch.Tensor) and a.shape == b.shape
            and a.dtype == b.dtype and a.device == b.device)


def _dtype_of(v):
    """A metric's dtype; a Python number has the one ``torch.as_tensor``
    gives it (the functional chunk stacks it so)."""
    if isinstance(v, torch.Tensor):
        return v.dtype
    if isinstance(v, bool):
        return torch.bool
    return torch.int64 if isinstance(v, int) else torch.get_default_dtype()


class CapturedStep:
    """Chunks of up to ``chunk`` steps of ``cfg`` replayed from CUDA graphs
    (on a CPU world, run eagerly with the same bookkeeping).  ``world``
    fixes the shapes and the terrain; :meth:`run` takes any world that
    :meth:`accepts`.  ``light`` as in ``driver.make_chunk_step``: light
    metrics on a chunk's interior steps, full metrics on its last."""

    def __init__(self, cfg: W.WorldConfig, world: W.World, chunk: int,
                 light: bool = False):
        why = capture_refusal(cfg)
        if why:
            raise ValueError(f"cannot capture this step: {why}")
        self.cfg = cfg
        self.chunk = int(chunk)
        self.light = bool(light)
        self.device = world.bodies.x.x.device
        self.graphs = self.device.type == "cuda"
        tree = (world.bodies, world.bp, world.warm)
        self._flat = _Flat(_leaves(tree), self.device)
        self._tree = _fill(tree, self._flat.views)
        # the static world: the buffers, and the caller's terrain tensors
        self.world = world._replace(**dict(zip(("bodies", "bp", "warm"),
                                               self._tree)))
        self._terrain = _leaves((world.terrain, world.terrain_center,
                                 world.terrain_grid))
        self._cached = W.reads_need(world, cfg)
        self.nonce = torch.ones((self.chunk,), dtype=torch.float32,
                                device=self.device)
        self.index = torch.zeros((1,), dtype=torch.int64, device=self.device)
        self._keys = None         # metric key -> (dtype, row)
        self._rows = None         # dtype -> (n_keys, C) metric buffer
        self._segments = {}       # variant -> (outputs, graph, launches)
        self._returned = None
        if self.graphs:
            self._side = torch.cuda.Stream(self.device)
        self._load(world)
        self.capture_seconds = 0.0
        self.graph_bytes = 0
        self.replays = 0

    @property
    def n_graphs(self) -> int:
        """The graphs captured so far."""
        return len(self._segments)

    # ---- the world in and out ----

    def accepts(self, world: W.World, chunk: int) -> bool:
        """Whether :meth:`run` can step ``world`` in chunks of ``chunk``
        steps (at most the stepper's): the same device, shapes and dtypes,
        and the same terrain tensors."""
        terrain = _leaves((world.terrain, world.terrain_center,
                           world.terrain_grid))
        return (1 <= int(chunk) <= self.chunk
                and _same_shapes((world.bodies, world.bp, world.warm),
                                 self._tree)
                and len(terrain) == len(self._terrain)
                and all(a is b for a, b in zip(terrain, self._terrain)))

    def _load(self, world):
        if self._returned is not None and world is self._returned[0] and all(
                b._version == v for b, v in self._returned[1]):
            return      # the world this stepper returned, unedited: the
                        # buffers hold it already
        for dst, src in zip(self._flat.views,
                            _leaves((world.bodies, world.bp, world.warm))):
            dst.copy_(src)

    def _snapshot(self):
        """The world in the buffers, as a copy (one per dtype)."""
        bufs = {d: b.clone() for d, b in self._flat.bufs.items()}
        out = self.world._replace(**dict(zip(
            ("bodies", "bp", "warm"),
            _fill(self._tree, self._flat.views_of(bufs)))))
        # an in-place edit of the copy bumps its version: then it loads
        self._returned = (out, [(b, b._version) for b in bufs.values()])
        return out

    # ---- the segments ----

    def _head(self, cfg):
        if tracing.ON:
            tracing.stamp("step_gap", self.device)
        b = self.world.bodies
        scale = torch.index_select(self.nonce, 0, self.index)
        w = self.world._replace(bodies=b._replace(force=b.force * scale))
        return W.step_head(w, cfg)

    def _tail(self, cfg, head, rebuild):
        new, metrics = W.step_tail(self.world, cfg, head, rebuild)
        self._commit(new, metrics)
        if tracing.ON:
            tracing.stamp("finish", self.device, rebuild)

    def _commit(self, new, metrics):
        """Copy the new state into the static buffers, write the metrics
        into row ``index``, advance the index."""
        src = _leaves((new.bodies, new.bp, new.warm))
        # a result that is a view of another static tensor is read before
        # any copy overwrites it
        src = [s.clone() if s is not d and self._flat.owns(s) else s
               for s, d in zip(src, self._flat.views)]
        for d, s in zip(self._flat.views, src):
            if s is not d:
                d.copy_(s)
        if self._keys is None:
            self._alloc_metrics(metrics)
        groups = {d: [] for d in self._rows}
        for k, v in metrics.items():
            dtype, _ = self._keys[k]
            if _dtype_of(v) != dtype:
                raise TypeError(f"metric {k!r} is {_dtype_of(v)}, was "
                                f"{dtype}")
            if not isinstance(v, torch.Tensor):
                v = torch.full((), v, dtype=dtype, device=self.device)
            groups[dtype].append(v)
        for dtype, vals in groups.items():
            self._rows[dtype].index_copy_(1, self.index,
                                          torch.stack(vals)[:, None])
        self.index.add_(1)

    def _alloc_metrics(self, metrics):
        self._keys, count = {}, {}
        for k, v in metrics.items():
            dtype = _dtype_of(v)
            self._keys[k] = (dtype, count.get(dtype, 0))
            count[dtype] = count.get(dtype, 0) + 1
        self._rows = {d: torch.zeros((n, self.chunk), dtype=d,
                                     device=self.device)
                      for d, n in count.items()}
        if self.graphs:
            # allocated during a warm-up on the side stream, used on the
            # caller's stream from then on
            for b in self._rows.values():
                b.record_stream(self._main)

    def _segment(self, key, fn, pure: bool):
        """Run one segment: replay its graph, or at first use run it
        eagerly and capture it.  ``pure`` segments (the head) write
        nothing but their outputs; the others (tails) commit a step."""
        if not self.graphs:
            return fn()
        seg = self._segments.get(key)
        if seg is not None:
            out, graph, rec = seg
            graph.replay()
            launches.add(rec)
            self.replays += 1
            return out
        self._main = torch.cuda.current_stream(self.device)
        self._side.wait_stream(self._main)
        with torch.cuda.stream(self._side):
            out = fn()
        self._main.wait_stream(self._side)
        t0 = time.perf_counter()
        with span_or_null()("graphs.capture"):
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()    # what the capture reserves is its own
            reserved = torch.cuda.memory_reserved(self.device)
            graph = torch.cuda.CUDAGraph()
            try:
                with launches.recording() as rec, torch.cuda.graph(
                        graph, capture_error_mode="global"):
                    captured = fn()
            except RuntimeError as e:
                raise RuntimeError(f"capturing step segment {key} failed: "
                                   f"{e}") from e
        self.capture_seconds += time.perf_counter() - t0
        self.graph_bytes += (torch.cuda.memory_reserved(self.device)
                             - reserved)
        self._segments[key] = (captured, graph, rec)
        if pure:
            # the warm-up's outputs are not the graph's: fill the graph's
            out = captured
            graph.replay()
            launches.add(rec)
            self.replays += 1
        return out

    # ---- a chunk ----

    def run(self, world: W.World, scales, schedule=None):
        """Step ``world`` one chunk with per-step force nonces ``scales``
        ((C,), C at most the stepper's chunk); ``schedule`` (iters, inner)
        overrides the config's solver schedule.  Returns (world, metrics
        stacked (C,) per key), both copies that later chunks do not
        touch."""
        why = capture_refusal(self.cfg)     # debug mode may be on by now
        if why:
            raise ValueError(f"cannot capture this step: {why}")
        if scales.dim() != 1 or not 1 <= scales.shape[0] <= self.chunk:
            raise ValueError(f"scales must be (C,) with 1 <= C <= "
                             f"{self.chunk}, got {tuple(scales.shape)}")
        C = scales.shape[0]
        on = tracing.ON
        span = span_or_null()
        if on:
            tracing.stamp("call_gap", self.device)
        with span("graphs.load"):
            self._load(world)
            self.nonce[:C].copy_(scales)
            self.index.zero_()
        if on:
            tracing.stamp("chunk_in", self.device)
        cfg = self.cfg
        if schedule is not None:
            cfg = cfg._replace(solver_iters=int(schedule[0]),
                               solver_inner=int(schedule[1]))
        sched = (cfg.solver_iters, cfg.solver_inner)
        for i in range(C):
            light = (i < C - 1) if self.light else cfg.light_metrics
            c = cfg._replace(light_metrics=light)
            if self._cached:
                with span("graphs.replay_head"):
                    head = self._segment(("head", light, on),
                                         lambda: self._head(c), pure=True)
                with span("graphs.need_read"):
                    rebuild = bool(head.need)
                with span("graphs.replay_tail"):
                    self._segment(("tail", light, rebuild, sched, on),
                                  lambda: self._tail(c, head, rebuild),
                                  pure=False)
            else:
                with span("graphs.replay_step"):
                    self._segment(("step", light, sched, on),
                                  lambda: self._tail(c, self._head(c), True),
                                  pure=False)
        with span("graphs.snapshot"):
            metrics = {d: b[:, :C].clone() for d, b in self._rows.items()}
            out = self._snapshot()
        if on:
            tracing.stamp("chunk_out", self.device)
        return out, {k: metrics[d][j] for k, (d, j) in self._keys.items()}

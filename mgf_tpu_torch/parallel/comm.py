"""The 1-D device mesh of the multi-device paths, on ``torch.distributed``.

The JAX package runs its multi-device steps under ``shard_map`` over a
one-axis ``Mesh``: every device executes the same program on its shard and
talks to the others through ``lax.ppermute``, ``all_gather``, ``psum`` and
``pmax``.  Here every device of that mesh is one RANK, one process, and a
:class:`Comm` stands for the mesh and its axis: it knows its rank, the
world size, the device its tensors live on and the process-group backend,
and it provides the same collectives with the same semantics:

* :meth:`Comm.axis_index` — ``lax.axis_index``;
* :meth:`Comm.ppermute_right` / :meth:`Comm.ppermute_left` — ``ppermute``
  with the shifts ``[(i, i + 1)]`` / ``[(i, i - 1)]``; a rank that
  receives from no one gets ZEROS, as ``ppermute`` gives;
  :meth:`Comm.exchange` runs both shifts in one batch;
* :meth:`Comm.all_gather_tiled` — ``all_gather(..., tiled=True)``;
* :meth:`Comm.psum` / :meth:`Comm.pmax`.

Backends (chosen by the caller, never as a fallback):

* ``"nccl"`` puts rank r on card r; :func:`run_ranks` refuses more ranks
  than cards before it spawns anything;
* ``"gloo"`` serves CPU ranks and ranks that share a card.  gloo's send
  and receive take CPU tensors only, so every collective of a rank on a
  card stages its tensor through host memory explicitly.

:func:`run_ranks` spawns the ranks (``spawn`` start method: a process with
a CUDA context cannot fork), meets them through a ``FileStore`` in a fresh
temporary directory (no fixed port, so concurrent runs never collide),
gives the process group a timeout (a mismatched collective fails the run
instead of hanging it), re-raises a rank's exception and returns every
rank's result with its tensors as numpy arrays.

``BYTES`` and ``MESSAGES`` count what this process sent to other ranks:
the payload bytes of each point-to-point message, and for a collective its
tensor once for every other rank (the logical volume, whatever algorithm
the backend runs); ``MESSAGES`` counts sends and collective calls.  Read
and reset them around a step, as the kernels' ``LAUNCHES``.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile

import torch
import torch.distributed as dist

BYTES = 0
MESSAGES = 0


def _count(n_bytes: int):
    global BYTES, MESSAGES
    BYTES += int(n_bytes)
    MESSAGES += 1


class Comm:
    """One rank of a 1-D mesh: ``rank``, ``size``, ``device`` (where this
    rank's tensors live) and ``backend``.  Every collective must be called
    by all ranks in the same order, as under ``shard_map``."""

    def __init__(self, rank: int, size: int, device, backend: str):
        self.rank = int(rank)
        self.size = int(size)
        self.device = torch.device(device)
        self.backend = backend
        # gloo moves CPU tensors only: a rank on a card stages through host
        self._stage = backend == "gloo" and self.device.type != "cpu"

    def axis_index(self) -> int:
        return self.rank

    def _out(self, x):
        return x.cpu().contiguous() if self._stage else x.contiguous()

    def _back(self, x):
        return x.to(self.device) if self._stage else x

    def exchange(self, to_left, to_right):
        """Both neighbour shifts in one batch: sends ``to_left`` to rank - 1
        and ``to_right`` to rank + 1; returns ``(from_left, from_right)``,
        what rank - 1 sent right and rank + 1 sent left.  Either send may be
        None (no message that way, and None comes back from that side);
        an edge rank receives zeros of its own tensor's shape."""
        ops, recv = [], {}
        for peer, send, back in ((self.rank - 1, to_left, to_right),
                                 (self.rank + 1, to_right, to_left)):
            if not 0 <= peer < self.size:
                continue
            if send is not None:
                buf = self._out(send)
                ops.append(dist.P2POp(dist.isend, buf, peer))
                _count(buf.numel() * buf.element_size())
            if back is not None:
                # the neighbour sends this way what this rank sends the
                # other way: same shape and dtype on every rank
                r = torch.empty(back.shape, dtype=back.dtype,
                                device="cpu" if self._stage else self.device)
                ops.append(dist.P2POp(dist.irecv, r, peer))
                recv[peer] = r
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        out = []
        for peer, mine in ((self.rank - 1, to_right), (self.rank + 1,
                                                        to_left)):
            if mine is None:
                out.append(None)
            elif peer in recv:
                out.append(self._back(recv[peer]))
            else:
                out.append(torch.zeros_like(mine))
        return out[0], out[1]

    def ppermute_right(self, x):
        """``ppermute(x, [(i, i + 1)])``: rank i's ``x`` goes to rank i + 1;
        rank 0 receives zeros."""
        return self.exchange(None, x)[0]

    def ppermute_left(self, x):
        """``ppermute(x, [(i, i - 1)])``: rank i's ``x`` goes to rank i - 1;
        the last rank receives zeros."""
        return self.exchange(x, None)[1]

    def all_gather_tiled(self, x, dim: int = 0):
        """``all_gather(x, tiled=True)`` along ``dim``: the ranks' tensors
        concatenated in rank order (all of one shape)."""
        if self.size == 1:
            return x
        buf = self._out(x)
        parts = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(parts, buf)
        _count(buf.numel() * buf.element_size() * (self.size - 1))
        return self._back(torch.cat(parts, dim=dim))

    def _all_reduce(self, x, op):
        if self.size == 1:
            return x
        buf = self._out(x).clone()
        dist.all_reduce(buf, op=op)
        _count(buf.numel() * buf.element_size() * (self.size - 1))
        return self._back(buf)

    def psum(self, x):
        return self._all_reduce(x, dist.ReduceOp.SUM)

    def pmax(self, x):
        return self._all_reduce(x, dist.ReduceOp.MAX)


def _rank_main(rank, fn, n, device, backend, store_path, out_dir,
               timeout_s, args):
    if device == "cpu":
        # ranks share the host's cores: one thread each
        torch.set_num_threads(1)
        rank_dev = torch.device("cpu")
    elif backend == "nccl":
        rank_dev = torch.device("cuda", rank)
    else:
        rank_dev = torch.device("cuda", rank % torch.cuda.device_count())
    if rank_dev.type == "cuda":
        torch.cuda.set_device(rank_dev)
    store = dist.FileStore(store_path, n)
    dist.init_process_group(backend, store=store, rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        comm = Comm(rank, n, rank_dev, backend)
        # every rank joins the group (and the backend starts: NCCL builds
        # its communicator here, even for one rank) before the first
        # neighbour message
        dist.all_reduce(comm._out(torch.zeros((1,), device=rank_dev)))
        result = fn(comm, *args)
        from mgf_tpu_torch.bridge import world_to_numpy
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(_to_numpy(result, world_to_numpy), fh)
    finally:
        dist.destroy_process_group()


def _to_numpy(tree, world_to_numpy):
    if isinstance(tree, list):
        return [_to_numpy(t, world_to_numpy) for t in tree]
    if isinstance(tree, dict):
        return {k: _to_numpy(v, world_to_numpy) for k, v in tree.items()}
    if isinstance(tree, (int, float, bool, str)) or tree is None:
        return tree
    return world_to_numpy(tree)


def run_ranks(fn, n: int, device="cuda", backend: str = None, *args,
              timeout_s: float = 600.0):
    """Run ``fn(comm, *args)`` on ``n`` ranks and return their results in
    rank order, every tensor as a numpy array.

    ``device`` is ``"cuda"`` or ``"cpu"`` (CPU ranks, one thread each);
    ``backend`` ``"nccl"`` (one rank per card: more ranks than cards raises
    here, before any process starts; the default on cards) or ``"gloo"``
    (any device, the default on the CPU; ranks on cards share them round
    robin and stage their messages through host memory).  ``fn`` and
    ``args`` are pickled into each rank, so ``fn`` must be a module-level
    function.  A rank's exception is raised here (the other ranks are
    stopped)."""
    device = str(device)
    if backend is None:
        backend = "nccl" if device == "cuda" else "gloo"
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"unknown backend {backend!r}")
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    if backend == "nccl":
        if device != "cuda":
            raise ValueError("the nccl backend runs ranks on cards")
        n_cards = torch.cuda.device_count()
        if n > n_cards:
            raise ValueError(f"nccl puts one rank on each card: {n} ranks, "
                             f"{n_cards} cards")
    tmp = tempfile.mkdtemp(prefix="mgf_ranks_")
    try:
        torch.multiprocessing.spawn(
            _rank_main, args=(fn, n, device, backend,
                              os.path.join(tmp, "store"), tmp, timeout_s,
                              args),
            nprocs=n, join=True, start_method="spawn")
        out = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as fh:
                out.append(pickle.load(fh))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

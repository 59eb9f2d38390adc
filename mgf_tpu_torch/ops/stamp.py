"""Stage time stamps in the stream: the hand-written CUDA kernel of
``csrc/stamp.cu`` and its plain version.

:func:`stamp` closes interval ``slot`` of a stamp buffer (int64, laid out
as the source describes: the last and the first stamp's clock, then a
nanosecond sum and a count per interval): the time since the previous
stamp is added to the interval, its count goes up by one, and the clock is
kept for the next stamp.  The first stamp after the buffer is zeroed only
opens an interval.  A CUDA buffer launches the one-thread kernel on the
current stream, so a CUDA-graph capture records it and every replay
stamps; the clock is the card's ``%globaltimer``.  A CPU buffer runs
:func:`stamp_reference`, the same bookkeeping on ``time.perf_counter_ns``.
A CUDA call that cannot build or launch the kernel raises.
"""

from __future__ import annotations

import ctypes
import time

import torch

from mgf_tpu_torch.ops import _build, launches

# kernel launches made by stamp in this process (a replayed graph counts
# the launches its capture recorded)
LAUNCHES = 0


def buffer_size(n_slots: int) -> int:
    """The int64 elements of a buffer with ``n_slots`` intervals."""
    return 2 + 2 * n_slots


def stamp_reference(buf: torch.Tensor, slot: int) -> None:
    """The plain version on a CPU buffer, with the host's clock."""
    now = time.perf_counter_ns()
    b = buf.numpy()
    if b[0] == 0:
        b[1] = now
    else:
        b[2 + 2 * slot] += now - b[0]
        b[3 + 2 * slot] += 1
    b[0] = now


def _lib():
    fn = _build.load("stamp").mgf_stamp
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def stamp(buf: torch.Tensor, slot: int) -> None:
    """Close interval ``slot`` of ``buf`` (see the module's text)."""
    if buf.dtype != torch.int64 or buf.dim() != 1 or \
            not buf.is_contiguous() or \
            not 0 <= slot < (buf.numel() - 2) // 2:
        raise ValueError(f"stamp needs a contiguous (2 + 2 * slots,) int64 "
                         f"buffer and a slot in it, got {buf.dtype} "
                         f"{tuple(buf.shape)} and slot {slot}")
    if buf.device.type == "cpu":
        stamp_reference(buf, slot)
        return
    if buf.device.type != "cuda":
        raise ValueError(f"stamp runs on cuda or cpu, not {buf.device}")
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    err = _lib()(buf.data_ptr(), int(slot), stream)
    if err != 0:
        raise RuntimeError(f"stamp kernel launch failed: cudaError {err}")
    launches.count(__name__, "LAUNCHES")

"""Launch counts that stay true when a CUDA graph replays the launches.

Each kernel wrapper calls :func:`count` where it launches its kernel.
Outside a graph capture that adds one to the wrapper module's counter
(``solver_sweep.LAUNCHES``, ``narrowphase.LAUNCHES``, ...).  While a
capture runs under :func:`recording`, the launch only enters the graph: it
is recorded instead, and every replay of the graph adds what was recorded
(:func:`add`), so a replayed launch counts as one made from Python does.
"""

from __future__ import annotations

import collections
import contextlib
import sys

_recorded = None     # a Counter while a capture records, else None


def count(module: str, counter: str) -> None:
    """One launch of the kernel counted by ``module``'s ``counter``."""
    if _recorded is not None:
        _recorded[(module, counter)] += 1
    else:
        mod = sys.modules[module]
        setattr(mod, counter, getattr(mod, counter) + 1)


@contextlib.contextmanager
def recording():
    """Record the launches made inside the block (a graph capture) instead
    of counting them; yields the Counter of (module, counter) -> launches."""
    global _recorded
    if _recorded is not None:
        raise RuntimeError("launch recording does not nest")
    _recorded = collections.Counter()
    try:
        yield _recorded
    finally:
        _recorded = None


def add(recorded) -> None:
    """Count the launches of one replay of a graph whose capture recorded
    ``recorded``."""
    for (module, counter), k in recorded.items():
        mod = sys.modules[module]
        setattr(mod, counter, getattr(mod, counter) + k)

"""Driver entry point of the port (twin of ``__graft_entry__.entry``).

:func:`entry` returns ``(fn, example_args)``: one physics step on the
balls scene (``balls_scene(num=6, with_dropped=True)``, 217 bodies), so
that ``fn(*example_args)`` runs it.  The scene lives on the CUDA card
unless the caller names another ``device``.  The multi-device dry run of
the JAX package comes with the port's multi-device paths.
"""

from __future__ import annotations

import functools

from mgf_tpu_torch.scenes import balls_scene
from mgf_tpu_torch.world import CUDA, step


def entry(device=CUDA):
    """Returns (fn, example_args): one physics step on the balls scene."""
    world, cfg = balls_scene(num=6, with_dropped=True, device=device)
    fn = functools.partial(step, cfg=cfg)
    return fn, (world,)

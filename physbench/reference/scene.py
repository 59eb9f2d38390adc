"""The reference's own initial scene, made from the seed: the bodies' start
positions and the box, worked out from a configuration's ``scene`` and
``bodies`` blocks without the program.  The benchmark holds the program's
first world against it (the start of every run)."""

from __future__ import annotations

import numpy as np


def stress_start(scene: dict, bodies: dict, seed: int):
    """A ``layers``-deep block of bodies 1.25 apart with a +-0.01 jitter
    drawn from ``seed``, above a floor at y = 0, in an open-top box whose
    walls stand 0.55 x the block's span + 6 from the centre, 40 high; with
    ``mixed``, every round(1 / cap_frac)-th body a capsule along x of axis
    ``capsule_axis``, the spheres first.  Returns (centres (N, 3) float32,
    is_capsule (N,) bool, box corners (8, 3) float32)."""
    n, layers = scene["n_bodies"], scene["layers"]
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n / layers)))
    idx = np.arange(side * side * layers)[:n]
    i, j, k = idx // (side * layers), (idx // layers) % side, idx % layers
    shift = 1.25
    pos = np.stack([(i - side / 2) * shift, 2.0 + k * shift,
                    (j - side / 2) * shift], -1).astype(np.float32)
    pos += rng.uniform(-0.01, 0.01, pos.shape).astype(np.float32)
    caps = np.zeros(n, bool)
    if scene.get("mixed"):
        caps = np.arange(n) % max(int(round(1.0 / scene["cap_frac"])), 1) == 0
    # spheres first; a capsule's centre is its start + axis / 2
    order = np.concatenate([np.nonzero(~caps)[0], np.nonzero(caps)[0]])
    centres = pos[order]
    wall = float(side * shift * 0.55 + 6.0)
    box = np.asarray([[sx * wall, y, sz * wall] for y in (0.0, 40.0)
                      for sx, sz in ((-1, -1), (-1, 1), (1, 1), (1, -1))],
                     np.float32)
    return centres, caps[order], box

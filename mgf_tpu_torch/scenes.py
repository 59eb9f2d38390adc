"""Scene builders (counterpart of ``mgf_tpu.scenes``): the sphere and
capsule demos, the heightfield terrain scene and the 100k stress piles.

* :func:`balls_scene` — the reference demo (mgf_demo/balls.rs:64-96): an
  11^3 grid of r=0.5 spheres plus one dropped from y=130 into the demo's
  open-top box, 20 two-phase solver sweeps, on the generic branch (packed
  grid, dense terrain, ``terrain_rows=4``).
* :func:`capsules_scene` — the capsules demo (capsules.rs:66-95): an 11^3
  grid of capsules over the same box, Mat3 inertia, the "mid" flank
  manifold, dense terrain with ``terrain_rows=6``.
* :func:`terrain_scene` — BASELINE config 3 as a simulated world: 10,000
  spheres and capsules (a quarter of them capsules) raining onto a
  10,368-triangle heightfield, on the generic branch with the grid-culled
  terrain narrowphase (``terrain_bp="grid"``) and ``solver_rows=14``.
* :func:`stress_scene` — the flagship: a ``layers``-deep block of r=0.5
  spheres settling into an open-top box, on the ``fused_iso`` branch; with
  ``mixed=True`` every fourth body is a capsule (BASELINE.json config 5's
  mixed form), type-sorted, on the generic branch with the type-partitioned
  narrowphase and the two-block solve.

Positions, terrain and configs are the JAX package's, field for field; see
that module for the measurements behind each setting.  Worlds go to the
CUDA card unless the caller names another ``device``.
"""

from __future__ import annotations

import numpy as np

from mgf_tpu_torch.broadphase import GridConfig
from mgf_tpu_torch.physics import SceneBuilder
from mgf_tpu_torch.world import (
    CUDA, WorldConfig, init_bp_cache, init_warm, make_world,
)

# demo terrain: open-top box, floor at y = -10, walls up to y = 0
# (world.rs:118-150: verts at y in {0, 10} shifted by set_pos to (0,-10,0))
_TERRAIN_VERTS = np.asarray([
    [-10.0, 0.0, -10.0],
    [-10.0, 0.0, 10.0],
    [10.0, 0.0, 10.0],
    [10.0, 0.0, -10.0],
    [-10.0, 10.0, -10.0],
    [-10.0, 10.0, 10.0],
    [10.0, 10.0, 10.0],
    [10.0, 10.0, -10.0],
], np.float32) + np.asarray([[0.0, -10.0, 0.0]], np.float32)

_TERRAIN_FACES = np.asarray([
    (0, 1, 3), (1, 2, 3),          # floor
    (0, 5, 1), (0, 4, 5),          # walls (world.rs:140-149)
    (0, 3, 7), (0, 7, 4),
    (2, 6, 3), (3, 6, 7),
    (1, 5, 2), (2, 5, 6),
], np.int32)


def _grid_positions(num, shift, y_base=10.0):
    """The demo's i/j/k grid (balls.rs:80-92)."""
    center = shift * num / 2.0
    pos = []
    for i in range(num):
        for j in range(num):
            for k in range(num):
                pos.append((i * shift - center,
                            y_base + j * shift + center * 2.0,
                            k * shift - center))
    return pos


def balls_scene(num: int = 11, with_dropped: bool = True,
                solver: str = "rows", *, device=CUDA):
    """The balls demo scene.  Returns (World, WorldConfig) with the world's
    tensors on ``device``."""
    b = SceneBuilder()
    rad = 0.5
    b.add_spheres(np.asarray(_grid_positions(num, 2.5 * rad), np.float32),
                  rad, mass=1.0, restitution=0.3, friction=0.6)
    if with_dropped:
        b.add_sphere((0.0, 130.0, 0.0), rad, mass=1.0, restitution=0.3,
                     friction=0.6)
    world = make_world(b.build(device), _TERRAIN_VERTS, _TERRAIN_FACES,
                       terrain_center=(0.0, -10.0, 0.0), device=device)
    # cell 2.0 >= the worst pair reach (settled ball 0.77 + the dropped
    # ball at terminal sweep ~1.15)
    cfg = WorldConfig(
        dt=1.0 / 60.0, solver_iters=20, shape_mode="spheres", solver=solver,
        grid=GridConfig(cell_size=2.0, dim=64, bucket_cap=10),
        max_pairs=16, fatten=0.25, terrain_rows=4)
    return world, cfg


def capsules_scene(num: int = 11, solver: str = "rows", *, device=CUDA):
    """The capsules demo scene (capsules.rs:66-95).  Returns (World,
    WorldConfig) with the world's tensors on ``device``.

    Faithful quirk: the reference grid spans x, z in [-27.5, 22.5]
    (shift 2.5 * rad with rad=2.0) while the demo box is only +-10, so
    MOST capsules miss the box and fall for ever, exactly as in the
    reference demo; only the middle ~3x3 columns land and settle."""
    b = SceneBuilder()
    rad = 2.0
    pos = np.asarray(_grid_positions(num, 2.5 * rad), np.float32)
    # capsule centered at p: a = p + (-0.5, 0, 0), d = (1, 0, 0), r = 1
    b.add_capsules(pos + np.asarray([[-0.5, 0.0, 0.0]], np.float32),
                   np.asarray([[1.0, 0.0, 0.0]], np.float32), 1.0,
                   mass=1.0, restitution=0.3, friction=0.6)
    world = make_world(b.build(device), _TERRAIN_VERTS, _TERRAIN_FACES,
                       terrain_center=(0.0, -10.0, 0.0), device=device)
    cfg = WorldConfig(
        dt=1.0 / 60.0, solver_iters=20, shape_mode="capsules", solver=solver,
        grid=GridConfig(cell_size=4.0, dim=64, bucket_cap=16),
        max_pairs=24, fatten=0.25, terrain_rows=6)
    return world, cfg


def terrain_scene(n_bodies: int = 10_000, grid_n: int = 72, seed: int = 2,
                  *, device=CUDA):
    """Mixed sphere/capsule bodies raining onto a >= 10k-triangle
    heightfield, with the grid-culled terrain narrowphase (mesh.rs:115-139,
    the BVH::query analog).  ``grid_n=72`` gives 72^2 * 2 = 10,368 faces.
    Returns (World, WorldConfig) with the world's tensors on ``device``."""
    rng = np.random.default_rng(seed)
    # heightfield: smooth sines, cell 2.0, amplitude 2
    cell = 2.0
    ext = grid_n * cell / 2.0
    xs = np.linspace(-ext, ext, grid_n + 1, dtype=np.float32)
    zs = np.linspace(-ext, ext, grid_n + 1, dtype=np.float32)
    X, Z = np.meshgrid(xs, zs, indexing="ij")
    Y = (2.0 * np.sin(X * 0.15) * np.cos(Z * 0.11)).astype(np.float32)
    verts = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)
    idx = np.arange((grid_n + 1) * (grid_n + 1)).reshape(grid_n + 1,
                                                         grid_n + 1)
    a = idx[:-1, :-1].ravel()
    b = idx[:-1, 1:].ravel()
    c = idx[1:, :-1].ravel()
    d = idx[1:, 1:].ravel()
    faces = np.concatenate(
        [np.stack([a, b, c], axis=-1), np.stack([b, d, c], axis=-1)],
        axis=0).astype(np.int32)

    side = int(np.ceil(n_bodies ** (1.0 / 3.0)))
    ii = np.arange(side ** 3)[:n_bodies]
    i, j, k = ii // (side * side), (ii // side) % side, ii % side
    shift = 1.4
    pos = np.stack([
        (i - side / 2) * shift,
        8.0 + j * shift,
        (k - side / 2) * shift,
    ], axis=-1).astype(np.float32)
    pos += rng.uniform(-0.02, 0.02, pos.shape).astype(np.float32)

    bld = SceneBuilder()
    caps = np.arange(n_bodies) % 4 == 0
    # spheres first: the type-partitioned step needs type-sorted bodies
    bld.add_spheres(pos[~caps], 0.5, mass=1.0, restitution=0.3, friction=0.6)
    bld.add_capsules(pos[caps] - np.asarray([[0.25, 0.0, 0.0]]),
                     np.asarray([[0.5, 0.0, 0.0]]), 0.5,
                     mass=1.0, restitution=0.3, friction=0.6)

    # face cell >= the largest face radius (plus the height slope)
    tg = GridConfig(cell_size=4.0, dim=64, bucket_cap=16)
    world = make_world(bld.build(device), verts, faces, terrain_grid_cfg=tg,
                       device=device)
    cfg = WorldConfig(
        dt=1.0 / 60.0, solver_iters=10, solver_inner=2, two_phase=False,
        shape_mode="mixed", solver="rows", broadphase="packed",
        grid=GridConfig(cell_size=1.6, dim=64, bucket_cap=8),
        max_pairs=12, fatten=0.1, terrain_bp="grid", terrain_cand=6,
        terrain_grid_cfg=tg, solver_rows=14,
        n_sphere_rows=int(np.sum(~caps)))
    return world, cfg


def stress_scene(n_bodies: int = 100_000, mixed: bool = False, seed: int = 0,
                 layers: int = 12, cap_frac: float = 0.25, *, device=CUDA):
    """The 100k-body stress config (BASELINE.json config 5): uniform r=0.5
    spheres, or with ``mixed`` a sphere/capsule mix in which every
    round(1/cap_frac)-th body is a capsule (``cap_frac >= 1``: all of them).
    Returns (World, WorldConfig) with the world's tensors on ``device``."""
    if mixed and not cap_frac > 0.0:
        raise ValueError(f"cap_frac must be > 0, got {cap_frac!r}")
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n_bodies / layers)))
    idx = np.arange(side * side * layers)[:n_bodies]
    i, j, k = idx // (side * layers), (idx // layers) % side, idx % layers
    shift = 1.25
    pos = np.stack([
        (i - side / 2) * shift,
        2.0 + k * shift,
        (j - side / 2) * shift,
    ], axis=-1).astype(np.float32)
    pos += rng.uniform(-0.01, 0.01, pos.shape).astype(np.float32)

    b = SceneBuilder()
    if mixed:
        if cap_frac >= 1.0:
            caps = np.ones(n_bodies, bool)
        else:
            caps = np.arange(n_bodies) % max(int(round(1.0 / cap_frac)),
                                             1) == 0
        # spheres first: the type-partitioned step needs type-sorted bodies
        b.add_spheres(pos[~caps], 0.5, mass=1.0, restitution=0.3,
                      friction=0.6)
        b.add_capsules(pos[caps] - np.asarray([[0.25, 0.0, 0.0]]),
                       np.asarray([[0.5, 0.0, 0.0]]), 0.5,
                       mass=1.0, restitution=0.3, friction=0.6)
    else:
        b.add_spheres(pos, 0.5, mass=1.0, restitution=0.3, friction=0.6)

    span = side * shift                  # initial pile footprint
    wall = float(span * 0.55 + 6.0)      # open-top box like the demo's
    wh = 40.0                            # wall height (world.rs:118-150)
    verts = np.asarray([
        [-wall, 0.0, -wall], [-wall, 0.0, wall], [wall, 0.0, wall],
        [wall, 0.0, -wall],
        [-wall, wh, -wall], [-wall, wh, wall], [wall, wh, wall],
        [wall, wh, -wall]], np.float32)
    faces = np.asarray([
        (0, 1, 3), (1, 2, 3),            # floor
        (0, 5, 1), (0, 4, 5),            # walls
        (0, 3, 7), (0, 7, 4),
        (2, 6, 3), (3, 6, 7),
        (1, 5, 2), (2, 5, 6)], np.int32)
    world = make_world(b.build(device), verts, faces, device=device)
    if mixed:
        # cell 2.0 >= the capsule-capsule pair reach (~1.54) with room for
        # the rebuild cadence's slack; the pile is flat, so y gets 16 cells
        grid = GridConfig(cell_size=2.0, dim=(128, 16, 128), bucket_cap=14)
        n_sph = int(np.sum(~caps))
    else:
        # grid modulus (dim * cell) must exceed the box span (2 * wall) or
        # occupied cells alias and buckets overflow silently
        dim = 32
        while dim * 1.6 < 2.0 * wall + 10.0:
            dim *= 2
        grid = GridConfig(cell_size=1.6, dim=(dim, 16, dim), bucket_cap=12)
    # K = 9 pair rows + 3 terrain candidates, no row compaction: 12 solver
    # rows for spheres, 2 * (9 + 3) = 24 for the mixed pile's two slots
    cfg = WorldConfig(
        dt=1.0 / 60.0, solver_iters=4, solver_inner=4, two_phase=False,
        adapt_schedule=(0.97, 2, 6),
        shape_mode="mixed" if mixed else "spheres",
        solver="rows", broadphase="fat27x4", solver_rows=0, warm_start=True,
        terrain_bp="near", terrain_cand=3,
        grid=grid, max_pairs=9, fatten=0.02,
        stable_pairs=True,
        n_sphere_rows=n_sph if mixed else -1,
        bp_every=8 if mixed else 32,
        warm_match="hybrid",
        # the hand-written sweep kernel serves the scalar-inertia fused
        # branch only; the mixed pile's capsule block has Mat3 inertia
        pallas_solver=not mixed,
        # capsule flank stacks rock on the single interval-midpoint contact;
        # "ends" emits the overlap interval's two endpoints
        cap_manifold="ends" if mixed else "mid",
        # full-gain warm pre-apply on sliding capsule contacts keeps a
        # mixed pile agitated; 0.8 damps the loop
        warm_gamma=0.8 if mixed else 1.0,
        fused_iso=not mixed)
    world = init_warm(world, cfg)
    world = init_bp_cache(world, cfg)
    return world, cfg

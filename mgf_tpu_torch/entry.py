"""Driver entry points of the port (twins of ``__graft_entry__``).

* :func:`entry` returns ``(fn, example_args)``: one physics step on the
  balls scene (``balls_scene(num=6, with_dropped=True)``, 217 bodies), so
  that ``fn(*example_args)`` runs it.  The scene lives on the CUDA card
  unless the caller names another ``device``.
* :func:`dryrun_multichip` runs the port's multi-device paths on
  ``n_devices`` ranks (``mgf_tpu_torch.parallel``): the spatial
  halo-exchange step, the all-gather step and the flagship stress config
  on the spatial path, a few steps each on tiny scenes.  It raises on any
  failure and never runs a smaller mesh.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from mgf_tpu_torch.scenes import balls_scene
from mgf_tpu_torch.world import CUDA, step


def entry(device=CUDA):
    """Returns (fn, example_args): one physics step on the balls scene."""
    world, cfg = balls_scene(num=6, with_dropped=True, device=device)
    fn = functools.partial(step, cfg=cfg)
    return fn, (world,)


def dryrun_multichip(n_devices: int, device=CUDA, backend: str = None):
    """Run the multi-device paths on ``n_devices`` ranks, each one process
    on ``device`` ("cuda" or "cpu"); ``backend`` defaults to "nccl" on the
    card (one rank per card: more ranks than cards raises before any
    process starts) and "gloo" on the CPU.  Raises on any failure (a
    rank's exception, NaNs, a bad trajectory, a stray body, bucket
    overflow, a cache that never engaged).  Returns rank 0's report lines,
    after printing them."""
    from mgf_tpu_torch.parallel import run_ranks
    lines = run_ranks(_dryrun_rank, int(n_devices),
                      torch.device(device).type, backend)[0]
    for line in lines:
        print(line)
    return lines


def _dryrun_rank(comm):
    """The dry run on one rank (``_dryrun_multichip_impl``'s three cases);
    every rank checks the gathered world."""
    from mgf_tpu_torch.parallel import (
        gather_world, init_spatial_bp_cache, make_sharded_step,
        make_spatial_step, shard_world, shard_world_spatial,
    )
    from mgf_tpu_torch.scenes import stress_scene
    n, dev = comm.size, comm.device
    lines = []
    # tiny scene: 4^3 = 64 bodies + 1 dropped ball (65 rows exercises the
    # non-divisible padding path for any power-of-two rank count)
    world, cfg = balls_scene(num=4, with_dropped=True, device=dev)
    drop_y0 = 130.0                             # the dropped ball starts here

    def run(label, w, step_fn):
        for _ in range(3):
            w, metrics = step_fn(w)
        b = gather_world(w, comm).bodies
        xs, ys = b.x.x.cpu().numpy(), b.x.y.cpu().numpy()
        if np.isnan(xs).any() or np.isnan(ys).any():
            raise RuntimeError(f"{label}: NaN after 3 sharded steps")
        # gravity must be pulling the dropped ball (the body nearest
        # y = 130, wherever sharding permuted it)
        y1 = float(ys[np.argmin(np.abs(ys - drop_y0))])
        if not y1 < drop_y0 - 1e-4:
            raise RuntimeError(
                f"{label}: dropped ball did not fall: y {drop_y0} -> {y1}")
        lines.append(f"{label} OK: {n}-rank mesh ({comm.backend}, {dev}), "
                     f"3 steps, drop y {drop_y0:.3f} -> {y1:.3f}")
        return metrics

    # 1. the scalable spatial (slab + halo exchange) design
    w_sp, bounds = shard_world_spatial(world, comm)
    m = run("spatial", w_sp, make_spatial_step(cfg, comm, bounds, halo=16))
    if int(m["spatial_stray"]) != 0:
        raise RuntimeError("spatial stray bodies on a fresh shard")
    # 2. the replicated all-gather fallback
    run("allgather", shard_world(world, comm), make_sharded_step(cfg, comm))
    # 3. the flagship stress-config semantics on the spatial path: warm
    #    starting, stable pairs, the width-4 fat grid, the "near" terrain
    #    cull, fused_iso counts, the bp cadence, hybrid warm matching and
    #    the adaptive schedule, the pile started near the floor so that
    #    contacts and warm rows form within a few steps
    w3, cfg3 = stress_scene(n_bodies=256, layers=3, device=dev)
    if not (cfg3.warm_start and cfg3.stable_pairs and cfg3.fused_iso
            and cfg3.broadphase in ("fat8x4", "fat27x4")
            and cfg3.terrain_bp == "near" and cfg3.bp_every > 1
            and cfg3.warm_match == "hybrid"
            and cfg3.adapt_schedule is not None):
        raise RuntimeError(f"stress_scene's config changed: {cfg3}")
    w3 = w3._replace(bodies=w3.bodies._replace(
        x=w3.bodies.x._replace(y=w3.bodies.x.y - 1.4)))
    w3s, b3 = shard_world_spatial(w3, comm, cfg=cfg3)
    f3 = make_spatial_step(cfg3, comm, b3, halo=32,
                           halo_width=cfg3.grid.cell_size)
    w3s = init_spatial_bp_cache(w3s, comm, cfg3, halo=32)
    rebuilds = 0
    for _ in range(8):
        w3s, m3 = f3(w3s)
        rebuilds += int(m3["broadphase_rebuilt"])
    ys3 = gather_world(w3s, comm).bodies.x.y
    if not bool(torch.isfinite(ys3).all()):
        raise RuntimeError("stress-config spatial: NaN after 8 steps")
    if int(m3["spatial_stray"]) != 0:
        raise RuntimeError("stress-config spatial: stray on a fresh shard")
    if int(m3["broadphase_overflow"]) != 0:
        raise RuntimeError("stress-config spatial: bucket overflow")
    if rebuilds >= 8:
        raise RuntimeError(
            "stress-config spatial: bp cadence never engaged "
            f"(rebuilt all {rebuilds}/8 steps)")
    if float(m3["broadphase_cache_drift_excess"]) != 0.0:
        raise RuntimeError("stress-config spatial: cache drift excess")
    lines.append(
        f"stress-config spatial OK: {n}-rank mesh, 8 steps, cadence engaged "
        f"({rebuilds}/8 rebuilds), contacts={int(m3['num_contacts'])}, "
        f"warm_hit={float(m3['warm_hit_frac']):.2f}, "
        f"comm={int(m3['comm_floats_per_step'])} floats")
    return lines

"""Rank-side scenarios of the port's multi-device tests.

Each function runs inside one rank started by
``mgf_tpu_torch.parallel.run_ranks`` and takes the rank's ``Comm`` first.
This module imports neither jax nor mgf_tpu, so a rank process starts with
torch and the port only; the tests convert the JAX package's worlds and
configs to the port's types before they hand them over.
"""

from __future__ import annotations

from mgf_tpu_torch import world_from_numpy
from mgf_tpu_torch.parallel import (
    gather_world, init_spatial_bp_cache, make_sharded_step,
    make_spatial_step, shard_world, shard_world_spatial,
)


def _host(m):
    return {k: v.detach().cpu() for k, v in m.items()}


def _snap(world, comm):
    g = gather_world(world, comm)
    return dict(bodies=g.bodies, warm=g.warm, bp=g.bp)


def spatial_run(comm, spec):
    """One spatial scenario: shard ``spec["world"]`` (the whole world, the
    port's types with numpy leaves), step it ``spec["steps"]`` times with
    ``spec["cfg"]``, and return the boundaries, the gathered shard before
    the first step, every step's metrics and gathered snapshots after the
    steps listed in ``spec["snaps"]``.  ``spec["reshard"]``: stop early
    once ``spatial_stray`` turns above 0, re-shard the gathered world and
    run ``spec["after"]`` more steps."""
    cfg, halo = spec["cfg"], spec["halo"]
    world = world_from_numpy(spec["world"], comm.device)
    w, bounds = shard_world_spatial(
        world, comm, cfg=cfg if cfg.warm_start else None)
    out = dict(bounds=bounds, shard0=_snap(w, comm), metrics=[], snaps={})
    make = lambda b: make_spatial_step(cfg, comm, b, halo=halo,
                                       halo_width=spec.get("halo_width"))
    f = make(bounds)
    if cfg.bp_every > 1:
        w = init_spatial_bp_cache(w, comm, cfg, halo)
    for i in range(spec["steps"]):
        w, m = f(w)
        out["metrics"].append(_host(m))
        if i + 1 in spec.get("snaps", ()):
            out["snaps"][i + 1] = _snap(w, comm)
        if spec.get("reshard") and int(m["spatial_stray"]) > 0:
            break
    if spec.get("reshard"):
        out["stray_step"] = len(out["metrics"])
        w, bounds = shard_world_spatial(gather_world(w, comm).
                                        _replace(warm=None, bp=None), comm)
        out["bounds2"] = bounds
        f = make(bounds)
        for _ in range(spec["after"]):
            w, m = f(w)
            out["metrics"].append(_host(m))
    out["final"] = _snap(w, comm)
    return out


def sharded_run(comm, spec):
    """One all-gather scenario: ``spec["steps"]`` steps of the sharded step
    on the padded, rank-cut world; every step's metrics, gathered snapshots
    after the steps in ``spec["snaps"]`` and the final gathered world."""
    world = world_from_numpy(spec["world"], comm.device)
    w = shard_world(world, comm)
    out = dict(shard0=_snap(w, comm), metrics=[], snaps={})
    f = make_sharded_step(spec["cfg"], comm)
    for i in range(spec["steps"]):
        w, m = f(w)
        out["metrics"].append(_host(m))
        if i + 1 in spec.get("snaps", ()):
            out["snaps"][i + 1] = _snap(w, comm)
    out["final"] = _snap(w, comm)
    return out


def run_specs(comm, specs):
    """Every scenario of a test module in one spawn of the ranks."""
    runs = dict(spatial=spatial_run, sharded=sharded_run)
    return [runs[s["kind"]](comm, s) for s in specs]


def exchange_edges(comm, h):
    """Both neighbour shifts of (h, 16) rows filled with the rank's index
    + 1: what every rank receives from each side."""
    import torch
    mine = torch.full((h, 16), float(comm.rank + 1), device=comm.device)
    from_left, from_right = comm.exchange(mine, mine * 10.0)
    return dict(from_left=from_left, from_right=from_right,
                right=comm.ppermute_right(mine), left=comm.ppermute_left(mine),
                gathered=comm.all_gather_tiled(mine[:1]),
                psum=comm.psum(mine[0, :1]), pmax=comm.pmax(mine[0, :1]))

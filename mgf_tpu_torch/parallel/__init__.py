"""The multi-device paths on ``torch.distributed`` (counterpart of
``mgf_tpu.parallel``).

Each device of the JAX package's 1-D mesh becomes one rank, one process
(:func:`run_ranks`), and a :class:`Comm` stands for the mesh axis.  Bodies
are sharded over the ranks: the replicated all-gather step
(:func:`make_sharded_step`) or the x-slab halo-exchange step
(:func:`make_spatial_step`).  :func:`gather_world` puts the ranks' shards
back into one world in rank order, the global arrays the JAX package's
sharded ``World`` is.
"""

from __future__ import annotations

from mgf_tpu_torch.math3d import tree_map
from mgf_tpu_torch.parallel.comm import Comm, run_ranks
from mgf_tpu_torch.parallel.sharded import make_sharded_step, shard_world
from mgf_tpu_torch.parallel.spatial import (init_spatial_bp_cache,
                                            make_spatial_step,
                                            shard_world_spatial)


def gather_world(world, comm):
    """Every rank's shard concatenated in rank order: the bodies and the
    broadphase cache along rows, the (R, n_loc) warm state along columns;
    the terrain as it is.  Every rank calls it and gets the whole world."""
    rows = lambda t: tree_map(lambda g: comm.all_gather_tiled(g), t)
    cols = lambda t: tree_map(lambda g: comm.all_gather_tiled(g, dim=1), t)
    return world._replace(bodies=rows(world.bodies), warm=cols(world.warm),
                          bp=rows(world.bp))


__all__ = ["Comm", "gather_world", "init_spatial_bp_cache",
           "make_sharded_step", "make_spatial_step", "run_ranks",
           "shard_world", "shard_world_spatial"]

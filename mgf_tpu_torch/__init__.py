"""mgf_tpu_torch — the PyTorch/CUDA port of mgf_tpu, for NVIDIA Hopper.

The JAX package ``mgf_tpu`` stays the reference; this package mirrors its
module names, NamedTuple types and field names, so every function here has
an obvious counterpart there.  It covers the sphere step on both of the
JAX package's sphere branches: the flagship ``stress_scene`` pile on the
``fused_iso`` branch (stepped by ``driver.AdaptiveChunkStepper``, the
solver's inner sweeps in CUDA kernel K1, ``ops/solver_sweep.py``), and the
generic branch of the demo ``balls_scene`` and the cold reference-schedule
pile (the pair contact in CUDA kernel K2, ``ops/narrowphase.py``);
capsules and the mixed pile on the generic branch; the reference's flat
solvers (the sequential sweeps in CUDA kernel K4,
``ops/sequential_solve.py``); meshes, compounds and the heightfield
``terrain_scene``; the rest of the shape library (``geom``, ``bounds``,
the ``collision`` predicates, ``ConvexMesh``), GJK/EPA on any pair of
convex supports (``gjk``) and the world queries: AABB overlap and ray casts
through the dense scans or the DDA grids (``queries``); every broadphase
mode and cache, the stage probes, world surgery and the capacity world
(``world``), checkpoints, slot tables, metrics and the debug mode
(``utils``), the entry point and the multi-device dry run (``entry``), and
the multi-device paths (``parallel``: the x-slab halo-exchange step and
the all-gather step, each device of the JAX package's mesh one rank of
``torch.distributed``).  ``gjk``, ``queries``, ``utils`` and ``parallel``
run as plain PyTorch, as the JAX package runs them as plain ``jnp``.

On the card the chunk driver (``driver.make_chunk_step``,
``AdaptiveChunkStepper``) replays the step from CUDA graphs
(``graphs.CapturedStep``), the counterpart of the JAX package's compiled
chunk, on the flagship, the generic sphere branch and the mixed pile.

The scene builders, ``make_world`` and ``SceneBuilder.build`` put their
tensors on the CUDA card unless the caller names another ``device``.  This
package imports neither ``jax`` nor ``mgf_tpu``.
"""

from mgf_tpu_torch import gjk, queries
from mgf_tpu_torch.bridge import world_from_numpy, world_to_numpy
from mgf_tpu_torch.driver import AdaptiveChunkStepper, make_chunk_step
from mgf_tpu_torch.scenes import balls_scene, stress_scene, terrain_scene
from mgf_tpu_torch.world import World, WorldConfig, step

__all__ = ["AdaptiveChunkStepper", "World", "WorldConfig", "balls_scene",
           "gjk", "make_chunk_step", "queries", "step", "stress_scene",
           "terrain_scene", "world_from_numpy", "world_to_numpy"]

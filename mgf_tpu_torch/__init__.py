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
``terrain_scene``.

The scene builders, ``make_world`` and ``SceneBuilder.build`` put their
tensors on the CUDA card unless the caller names another ``device``.  This
package imports neither ``jax`` nor ``mgf_tpu``.
"""

from mgf_tpu_torch.bridge import world_from_numpy, world_to_numpy
from mgf_tpu_torch.driver import AdaptiveChunkStepper, make_chunk_step
from mgf_tpu_torch.scenes import balls_scene, stress_scene, terrain_scene
from mgf_tpu_torch.world import World, WorldConfig, step

__all__ = ["AdaptiveChunkStepper", "World", "WorldConfig", "balls_scene",
           "make_chunk_step", "step", "stress_scene", "terrain_scene",
           "world_from_numpy", "world_to_numpy"]

"""mgf_tpu_torch — the PyTorch/CUDA port of mgf_tpu, for NVIDIA Hopper.

The JAX package ``mgf_tpu`` stays the reference; this package mirrors its
module names, NamedTuple types and field names, so every function here has
an obvious counterpart there.  It covers the flagship slice: the
``stress_scene`` sphere pile stepped on the ``fused_iso`` branch by
``driver.AdaptiveChunkStepper``, with the solver's inner sweeps in a
hand-written CUDA kernel (``ops/solver_sweep.py``).

Every tensor-creating entry point takes an explicit ``device``.  This
package imports neither ``jax`` nor ``mgf_tpu``.
"""

from mgf_tpu_torch.bridge import world_from_numpy, world_to_numpy
from mgf_tpu_torch.driver import AdaptiveChunkStepper, make_chunk_step
from mgf_tpu_torch.scenes import stress_scene
from mgf_tpu_torch.world import World, WorldConfig, step

__all__ = ["AdaptiveChunkStepper", "World", "WorldConfig",
           "make_chunk_step", "step", "stress_scene", "world_from_numpy",
           "world_to_numpy"]

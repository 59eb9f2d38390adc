"""Hand-written CUDA kernels of mgf_tpu_torch, each with its plain PyTorch
version beside it (used for CPU tensors) and a launch counter.

* K1 ``solver_sweep.inner_sweeps`` and ``inner_sweeps_gather`` (the same
  kernel with the partner gather inside) — replaces the Pallas TPU kernel
  ``mgf_tpu/ops/solver_sweep.py::inner_sweeps`` and the gather before it;
* K2 ``narrowphase.sphere_contact_pairs`` — replaces
  ``mgf_tpu/ops/narrowphase.py::sphere_contact_pairs``;
* K3 ``solver_sweep.inner_sweeps_blockmajor`` — K1's kernel over the
  block-major layout of ``scripts/micro_sweep.py::run_blockmajor``;
* K5 ``terrain.sphere_terrain_near`` — the sphere step's "near" terrain
  stage (cull, triangle contacts, one-slot manifold) in one pass per body;
  it replaces no TPU kernel.

Sources live in ``csrc/`` and are built by ``_build`` at first use
(``_build.build_all()`` builds every source at once).  Each wrapper counts
its launches through ``launches.count``, which keeps the counts true when
a CUDA graph replays the launches (``graphs.CapturedStep``).
"""

"""Hand-written CUDA kernels of mgf_tpu_torch, each with its plain PyTorch
version beside it (used for CPU tensors) and a launch counter.

* ``solver_sweep.inner_sweeps`` — replaces the Pallas TPU kernel
  ``mgf_tpu/ops/solver_sweep.py::inner_sweeps``.

Sources live in ``csrc/`` and are built by ``_build`` at first use.
"""

"""Kernel K1 (mgf_tpu_torch/ops/csrc/solver_sweep.cu) against its plain
PyTorch version on the card.  Runs only where CUDA is available: each test
takes the ``cuda_device`` fixture, which skips without a card (decided at
run time, never at import).

Tolerance atol 2e-4 / rtol 1e-4 (as tests/test_solver_sweep.py): the
kernel sums rows sequentially with fused multiply-adds, the plain version
through torch reductions in another order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mgf_tpu_torch.ops import solver_sweep as ss  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    return torch.device("cuda")


def _rows(R, N, dev, seed=0):
    rng = np.random.default_rng(seed)
    nrm = rng.standard_normal((3, R, N))
    nrm /= np.linalg.norm(nrm, axis=0, keepdims=True)
    t1 = np.cross(nrm, np.asarray([1.0, 0.1, -0.2])[:, None, None] + 0 * nrm,
                  axis=0)
    t1 /= np.linalg.norm(t1, axis=0, keepdims=True)
    t2 = np.cross(nrm, t1, axis=0)
    valid = rng.uniform(size=(1, R, N)) < 0.7
    # effective masses split by each column's valid-row count, as the
    # flagship's constraint build does (unsplit, 12 Jacobi rows overshoot)
    count = np.maximum(valid.sum(axis=1, keepdims=True), 1)
    fields = np.concatenate([
        nrm, t1, t2, rng.standard_normal((3, R, N)) * 0.4,
        rng.uniform(0.2, 0.8, (1, R, N)), rng.uniform(-0.5, 1.5, (1, R, N)),
        rng.uniform(0.2, 1.0, (3, R, N)) / count, valid], axis=0)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return (t(rng.standard_normal((8, N))), t(fields),
            t(rng.standard_normal((3, R, N)) * 0.5),
            t(rng.uniform(0.5, 1.5, (2, N))),
            t(rng.uniform(0.0, 0.3, (3, R, N))))


@pytest.mark.parametrize("R,N,inner", [(12, 100_000, 4), (12, 100_000, 6),
                                       (5, 1000, 3), (12, 700, 1)])
def test_kernel_matches_plain(cuda_device, R, N, inner):
    args = _rows(R, N, cuda_device)
    before = ss.LAUNCHES
    s_k, a_k = ss.inner_sweeps(*args, inner)
    assert ss.LAUNCHES == before + 1
    s_p, a_p = ss.inner_sweeps_reference(*args, inner)
    torch.cuda.synchronize()
    torch.testing.assert_close(s_k, s_p, atol=2e-4, rtol=1e-4)
    torch.testing.assert_close(a_k, a_p, atol=2e-4, rtol=1e-4)
    assert torch.equal(s_k[6:], args[0][6:])


def test_kernel_rejects_bad_inputs(cuda_device):
    S, f, term, sp, acc = _rows(3, 64, cuda_device)
    with pytest.raises(ValueError):
        ss.inner_sweeps(S, f[:, :, :32], term, sp, acc, 2)
    with pytest.raises(ValueError):
        ss.inner_sweeps(S.cpu(), f, term, sp, acc, 2)

"""Kernels K1 (mgf_tpu_torch/ops/csrc/solver_sweep.cu in term and gather
mode), K3 (the same kernel over the block-major layout) and K2
(ops/csrc/sphere_contact.cu) against their plain PyTorch versions on the
card.  Runs only where CUDA is available:
each test takes the ``cuda_device`` fixture, which skips without a card
(decided at run time, never at import).

Tolerances: K1/K3 atol 2e-4 / rtol 1e-4 (as tests/test_solver_sweep.py):
the kernel sums rows sequentially with fused multiply-adds, the plain
version through torch reductions in another order.  K2: valid exactly, t
and n atol 1e-4, witness points atol 1e-3 (tests/test_ops_native.py's
gate; rsqrtf is approximate).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mgf_tpu_torch.ops import narrowphase as nph  # noqa: E402
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


def _gather_inputs(args, M, K, seed=1):
    """Gather-mode inputs from _rows' term-mode ones: the (8, M) state
    (statics past N), (R, N) partners with out-of-range entries (= N and
    = M) on rows that are not valid, and (3, K, N) partner contact
    points."""
    S, fields, _, self_p, acc = args
    R, N = fields.shape[1:]
    dev = S.device
    rng = np.random.default_rng(seed)
    S_full = torch.as_tensor(rng.standard_normal((8, M)).astype(np.float32),
                             device=dev)
    S_full[:, :N] = S
    partner = rng.integers(0, M, (R, N))
    bad = (~fields[17].bool().cpu().numpy()) & (rng.uniform(size=(R, N)) < 0.5)
    partner[bad] = np.where(rng.uniform(size=int(bad.sum())) < 0.5, N, M)
    rb = rng.standard_normal((3, K, N)).astype(np.float32) * 0.4
    return (S_full, fields, torch.as_tensor(partner.astype(np.int32),
                                            device=dev),
            torch.as_tensor(rb, device=dev), self_p, acc)


_SHAPES = [(12, 100_000, 4), (12, 100_000, 6), (5, 1000, 3), (12, 700, 1),
           (1, 700, 3), (1, 100_000, 1), (32, 1000, 6), (32, 100_000, 4),
           (5, 100_000, 6), (32, 700, 1)]


@pytest.mark.parametrize("mode", ["term", "gather"])
@pytest.mark.parametrize("R,N,inner", _SHAPES)
def test_kernel_matches_plain(cuda_device, mode, R, N, inner):
    args = _rows(R, N, cuda_device)
    before = ss.LAUNCHES
    if mode == "term":
        s_k, a_k = ss.inner_sweeps(*args, inner)
        s_p, a_p = ss.inner_sweeps_reference(*args, inner)
        S = args[0]
    else:
        # flagship-like: statics past N, the last 3 rows static (K < R)
        gin = _gather_inputs(args, N + 3, max(R - 3, 0))
        s_k, a_k = ss.inner_sweeps_gather(*gin, inner, max(R - 3, 0))
        s_p, a_p = ss.inner_sweeps_gather_reference(*gin, inner,
                                                    max(R - 3, 0))
        S = gin[0]
    assert ss.LAUNCHES == before + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(s_k, s_p, atol=2e-4, rtol=1e-4)
    torch.testing.assert_close(a_k, a_p, atol=2e-4, rtol=1e-4)
    assert torch.equal(s_k[6:], S[6:])
    assert torch.equal(s_k[:, N:], S[:, N:])


@pytest.mark.parametrize("K,extra", [(12, 0), (9, 0), (0, 5), (4, 1000)])
def test_gather_kernel_partner_edges(cuda_device, K, extra):
    """Gather mode on purpose: partners out of range (= N, = M), static
    tail rows (K < R, K = 0), M > N with the tail columns returned
    unchanged, partners past N (statics) read from the input state."""
    R, N = 12, 4000
    args = _rows(R, N, cuda_device, seed=3)
    gin = _gather_inputs(args, N + extra, K, seed=4)
    s_k, a_k = ss.inner_sweeps_gather(*gin, 5, K)
    s_p, a_p = ss.inner_sweeps_gather_reference(*gin, 5, K)
    torch.cuda.synchronize()
    torch.testing.assert_close(s_k, s_p, atol=2e-4, rtol=1e-4)
    torch.testing.assert_close(a_k, a_p, atol=2e-4, rtol=1e-4)
    assert torch.equal(s_k[:, N:], gin[0][:, N:])


def test_kernel_rejects_bad_inputs(cuda_device):
    S, f, term, sp, acc = _rows(3, 64, cuda_device)
    with pytest.raises(ValueError):
        ss.inner_sweeps(S, f[:, :, :32], term, sp, acc, 2)
    with pytest.raises(ValueError):
        ss.inner_sweeps(S.cpu(), f, term, sp, acc, 2)
    # R = 33 is more than a CUDA block of 32 x R threads holds
    with pytest.raises(ValueError):
        ss.inner_sweeps(*_rows(33, 64, cuda_device), 2)
    gin = _gather_inputs(_rows(33, 64, cuda_device), 64, 30)
    with pytest.raises(ValueError):
        ss.inner_sweeps_gather(*gin, 2, 30)
    # a K3 block that is not a multiple of 32 (unless it is the whole width)
    blk = [_to_blocks(x, 48) for x in _rows(3, 96, cuda_device)]
    with pytest.raises(ValueError):
        ss.inner_sweeps_blockmajor(*blk, 2)


def _to_blocks(x, block):
    """(C, [R,] N) -> (N // block, C, [R,] block), contiguous."""
    nb = x.shape[-1] // block
    return x.reshape(*x.shape[:-1], nb, block).movedim(-2, 0).contiguous()


@pytest.mark.parametrize("block,inner", [(512, 1), (2048, 8), (256, 3)])
def test_blockmajor_kernel_matches_plain(cuda_device, block, inner):
    args = _rows(12, 8192, cuda_device, seed=2)
    blk = [_to_blocks(x, block) for x in args]
    before, before_k1 = ss.BLOCKMAJOR_LAUNCHES, ss.LAUNCHES
    s_k, a_k = ss.inner_sweeps_blockmajor(*blk, inner)
    assert ss.BLOCKMAJOR_LAUNCHES == before + 1
    assert ss.LAUNCHES == before_k1
    s_p, a_p = ss.inner_sweeps_blockmajor_reference(*blk, inner)
    torch.cuda.synchronize()
    torch.testing.assert_close(s_k, s_p, atol=2e-4, rtol=1e-4)
    torch.testing.assert_close(a_k, a_p, atol=2e-4, rtol=1e-4)
    # the same sweeps as K1 on the (C, R, N) layout
    s1, _ = ss.inner_sweeps(*args, inner)
    torch.testing.assert_close(s_k, _to_blocks(s1, block), atol=1e-6,
                               rtol=0)


def _pair_blocks(P, dev, seed=0):
    rng = np.random.default_rng(seed)
    ga = rng.standard_normal((8, P)).astype(np.float32)
    gb = rng.standard_normal((8, P)).astype(np.float32)
    ga[6] = np.abs(ga[6]) + 0.1
    gb[6] = np.abs(gb[6]) + 0.1
    gb[:, 0] = ga[:, 0]              # coincident centres, equal sweeps
    gb[:3, 1] = ga[:3, 1]            # coincident centres, moving
    return (torch.as_tensor(ga, device=dev), torch.as_tensor(gb, device=dev))


@pytest.mark.parametrize("P", [900_000, 4096, 1000])
def test_sphere_contact_kernel_matches_plain(cuda_device, P):
    ga, gb = _pair_blocks(P, cuda_device)
    before = nph.LAUNCHES
    ck = nph.sphere_contact_pairs(ga, gb)
    assert nph.LAUNCHES == before + 1
    cp = nph.sphere_contact_pairs_reference(ga, gb)
    torch.cuda.synchronize()
    assert torch.equal(ck.valid, cp.valid)
    v = cp.valid
    assert bool(v[1]) and not bool(v[0])
    for a, b in zip([*ck.n, ck.t], [*cp.n, cp.t]):
        torch.testing.assert_close(a[v], b[v], atol=1e-4, rtol=0)
    for a, b in zip([*ck.a, *ck.b], [*cp.a, *cp.b]):
        torch.testing.assert_close(a[v], b[v], atol=1e-3, rtol=0)


def test_sphere_contact_rejects_bad_inputs(cuda_device):
    ga, gb = _pair_blocks(64, cuda_device)
    with pytest.raises(ValueError):
        nph.sphere_contact_pairs(ga, gb.cpu())
    with pytest.raises(ValueError):
        nph.sphere_contact_pairs(ga[:, :32], gb)

"""Kernels K1 (mgf_tpu_torch/ops/csrc/solver_sweep.cu in term and gather
mode), K3 (the same kernel over the block-major layout), K2
(ops/csrc/sphere_contact.cu) and K4 (ops/csrc/sequential_solve.cu) against
their plain PyTorch versions on the card.  Runs only where CUDA is
available:
each test takes the ``cuda_device`` fixture, which skips without a card
(decided at run time, never at import).

Tolerances: K1/K3 atol 2e-4 / rtol 1e-4 (as tests/test_solver_sweep.py):
the kernel sums rows sequentially with fused multiply-adds, the plain
version through torch reductions in another order.  K2: valid exactly, t
and n atol 1e-4, witness points atol 1e-3 (tests/test_ops_native.py's
gate; rsqrtf is approximate).  K4 against its plain version run on CPU
copies of the same inputs: v and omega atol 1e-4 + rtol 1e-5; and the
level-by-level K4 against the SERIAL plain version on CPU copies
(``sequential_solve_reference``, one point at a time): ``torch.equal``, no
tolerance (both round every product and sum once, in the same order, and
updates of one level share no dynamic body), on the lists of
tests/test_torch_sequential_levels.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mgf_tpu_torch.ops import narrowphase as nph  # noqa: E402
from mgf_tpu_torch.ops import sequential_solve as seq  # noqa: E402
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


def _landing_inputs(dev, steps=141):
    """K4's inputs at the 126-body balls_scene(5) landing: the port steps
    the demo with the parallel flat solver (no K4) for ``steps`` steps,
    then one sequential step records its constraint list (at 141 steps the
    block hits the floor: 117 valid points, velocities change by ~45)."""
    from mgf_tpu_torch import world as tworld
    from mgf_tpu_torch.scenes import balls_scene

    world, cfg = balls_scene(5, device=dev)
    par = cfg._replace(solver="parallel")
    for _ in range(steps):
        world, _ = tworld.step(world, par)
    return seq.capture_inputs(
        lambda: tworld.step(world, cfg._replace(solver="sequential")))[0]


def _k4_vs_plain(inp, iters, mgf):
    before = seq.LAUNCHES
    out = seq.sequential_solve(inp["pts"], inp["a"], inp["b"], inp["valid"],
                               inp["bodies"], iters, mgf)
    assert seq.LAUNCHES == before + 1
    cpu = {k: v.cpu() for k, v in inp.items() if torch.is_tensor(v)}
    ref = seq.sequential_solve(cpu["pts"], cpu["a"], cpu["b"], cpu["valid"],
                               cpu["bodies"], iters, mgf)
    assert seq.LAUNCHES == before + 1
    torch.cuda.synchronize()
    assert out.shape == ref.shape == (inp["bodies"].shape[0], 6)
    torch.testing.assert_close(out.cpu(), ref, atol=1e-4, rtol=1e-5)
    return out.cpu(), ref


@pytest.mark.parametrize("mgf", [False, True])
def test_sequential_kernel_matches_plain(cuda_device, mgf):
    inp = _landing_inputs(cuda_device)
    n_valid = int(inp["valid"].sum())
    assert 50 < n_valid < inp["valid"].numel()
    out, ref = _k4_vs_plain(inp, 20, mgf)
    # the solve moved the landing bodies
    assert float((out[:, :3] - inp["bodies"][:, :3].cpu()).abs().max()) > 0.1


def test_sequential_kernel_all_invalid(cuda_device):
    inp = _landing_inputs(cuda_device, steps=1)
    inp["valid"] = torch.zeros_like(inp["valid"])
    out, _ = _k4_vs_plain(inp, 20, False)
    assert torch.equal(out, inp["bodies"][:, :6].cpu())


def _random_inputs(C, M, dev, seed=0):
    """C points over M bodies (the last one static), all valid but every
    seventh, with unit normals and tangents, Mat3 inverse inertia."""
    rng = np.random.default_rng(seed)
    n = rng.standard_normal((C, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    t1 = np.cross(n, [1.0, 0.1, -0.2])
    t1 /= np.linalg.norm(t1, axis=1, keepdims=True)
    t2 = np.cross(n, t1)
    pts = np.concatenate([rng.standard_normal((C, 6)) * 0.4, n, t1, t2,
                          rng.uniform(0.3, 0.8, (C, 1)),
                          rng.uniform(0.0, 1.0, (C, 1)),
                          rng.uniform(0.2, 0.6, (C, 3))], axis=1)
    a = rng.integers(0, M - 1, C)
    b = (a + rng.integers(1, M, C)) % M
    q = np.linalg.qr(rng.standard_normal((M, 3, 3)))[0]
    inertia = np.einsum("mij,mj,mkj->mik", q, rng.uniform(0.5, 2.0, (M, 3)),
                        q).reshape(M, 9)
    bodies = np.concatenate([rng.standard_normal((M, 6)),
                             rng.uniform(0.5, 1.5, (M, 1)), inertia], axis=1)
    bodies[-1] = 0.0
    t = lambda x, dt: torch.as_tensor(np.ascontiguousarray(x).astype(dt),
                                      device=dev)
    return dict(pts=t(pts, np.float32), a=t(a, np.int32), b=t(b, np.int32),
                valid=t(np.arange(C) % 7 != 3, np.bool_),
                bodies=t(bodies, np.float32))


@pytest.mark.parametrize("C,M", [(1000, 50), (257, 9), (1, 2),
                                 (9000, 3000), (600, 6000)])
def test_sequential_kernel_shapes(cuda_device, C, M):
    """C not a multiple of the block's 256 threads; the accumulators past
    the shared memory left after 3,000 bodies (9,000 points); the bodies
    past the shared memory (6,000)."""
    out, _ = _k4_vs_plain(_random_inputs(C, M, cuda_device), 3, False)
    assert torch.equal(out[-1], torch.zeros(6))          # the static row


def test_sequential_kernel_rejects_bad_inputs(cuda_device):
    inp = _random_inputs(64, 8, cuda_device)
    with pytest.raises(ValueError):
        seq.sequential_solve(inp["pts"], inp["a"], inp["b"], inp["valid"],
                             inp["bodies"].cpu(), 2, False)
    with pytest.raises(TypeError):
        seq.sequential_solve(inp["pts"], inp["a"].long(), inp["b"],
                             inp["valid"], inp["bodies"], 2, False)
    with pytest.raises(ValueError):
        seq.sequential_solve(inp["pts"][:, :19].contiguous(), inp["a"],
                             inp["b"], inp["valid"], inp["bodies"], 2, False)


def _k4_vs_serial(inp, iters, mgf):
    """K4 on the card against the serial plain version on CPU copies of
    the same inputs: equal bit for bit."""
    dev = inp["pts"].device
    before = seq.LAUNCHES
    out = seq.sequential_solve(inp["pts"], inp["a"], inp["b"], inp["valid"],
                               inp["bodies"], iters, mgf)
    assert seq.LAUNCHES == before + 1
    cpu = {k: v.cpu() for k, v in inp.items() if torch.is_tensor(v)}
    ref = seq.sequential_solve_reference(cpu["pts"], cpu["a"], cpu["b"],
                                         cpu["valid"], cpu["bodies"], iters,
                                         mgf)
    torch.cuda.synchronize(dev)
    out = out.cpu()
    assert out.shape == ref.shape == (inp["bodies"].shape[0], 6)
    assert torch.equal(out, ref), float((out - ref).abs().max())
    return out, ref


def _on(inp, dev):
    return {k: v.to(dev) for k, v in inp.items() if torch.is_tensor(v)}


@pytest.mark.parametrize("mgf", [False, True])
def test_sequential_kernel_bit_exact_landing(cuda_device, mgf):
    inp = _landing_inputs(cuda_device)
    out, _ = _k4_vs_serial(inp, 20, mgf)
    assert float((out[:, :3] - inp["bodies"][:, :3].cpu()).abs().max()) > 0.1


@pytest.mark.parametrize("mgf", [False, True])
@pytest.mark.parametrize("C,M", [(1000, 50), (257, 9), (1, 2),
                                 (9000, 3000), (600, 6000)])
def test_sequential_kernel_bit_exact_shapes(cuda_device, C, M, mgf):
    from test_torch_sequential_levels import random_list
    _k4_vs_serial(_on(random_list(C, M), cuda_device), 3, mgf)


@pytest.mark.parametrize("C", [1000, 5000])
def test_sequential_kernel_wide_level(cuda_device, C):
    """One level of C points, no body shared (2 C + 1 bodies): wider than
    the block's 512 threads, so each thread takes several points."""
    from test_torch_sequential_levels import disjoint_list
    inp = disjoint_list(C)
    assert int(seq.sequential_schedule(inp["a"], inp["b"], inp["valid"],
                                       inp["bodies"]).max()) == 1
    _k4_vs_serial(_on(inp, cuda_device), 3, False)


def test_sequential_kernel_chain(cuda_device):
    """Every point on one dynamic body: as many levels as valid points."""
    from test_torch_sequential_levels import chain_list
    _k4_vs_serial(_on(chain_list(), cuda_device), 3, True)


def test_sequential_kernel_static_row(cuda_device):
    """Every partner the static row: it comes out bit for bit as it went
    in (the kernel never writes it)."""
    from test_torch_sequential_levels import static_partner_list
    inp = static_partner_list()
    out, _ = _k4_vs_serial(_on(inp, cuda_device), 3, False)
    assert torch.equal(out[-1].view(torch.int32),
                       inp["bodies"][-1, :6].view(torch.int32))

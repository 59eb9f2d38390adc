"""Parity of the port's row solver (mgf_tpu_torch.solver) and of kernel K1's
plain versions (ops/solver_sweep.inner_sweeps_reference and, for the gather
mode, inner_sweeps_gather_reference) with mgf_tpu's.

The port-side twins of tests/test_solver_sweep.py: the same random row
systems, made with numpy, go through mgf_tpu.solve_rows (pallas_inner
False, and True with the Pallas kernel in interpret mode) and through the
port's solve_rows with the same flag (on CPU tensors the port's kernel
wrapper runs its plain PyTorch version).

Tolerance atol 2e-4, rtol 1e-4 as test_solver_sweep.py: the sweeps sum
impulses over rows in another order than XLA's fused reductions, and
4-12 sweeps compound that float32 noise.  Accumulators are compared on
valid rows only (the jnp path also updates invalid rows, the kernel masks
them; invalid-row accumulators are never consumed).

The Mat3 path of capsules rides the same tolerance: ``build_row_constraints``
over a column block (floats atol 1e-5 + rtol 1e-5, masks exact), the cold
20-sweep two-phase solve with Mat3 inertia, and the mixed pile's two chained
block solves (``col_offset``, ``state0``, ``return_state``; warm, 4 x 4
single-phase).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from mgf_tpu import solver as jsol  # noqa: E402
from mgf_tpu.manifold import Manifold as JManifold  # noqa: E402
from mgf_tpu.math3d import Mat3 as JMat3  # noqa: E402
from mgf_tpu.math3d import Vec3 as JVec3  # noqa: E402

from mgf_tpu_torch import solver as tsol  # noqa: E402
from mgf_tpu_torch.manifold import Manifold as TManifold  # noqa: E402
from mgf_tpu_torch.math3d import Mat3 as TMat3  # noqa: E402
from mgf_tpu_torch.math3d import Vec3 as TVec3  # noqa: E402
from mgf_tpu_torch.ops import solver_sweep as tss  # noqa: E402


def _unit(a):
    return (a / (np.linalg.norm(a, axis=0, keepdims=True) + 1e-9)).astype(
        np.float32)


def _random_rows(n=700, R=6, seed=0, valid_frac=0.7, m_extra=1):
    """A random self-consistent row system (test_solver_sweep.py:21-63 in
    numpy): unit normals, orthonormal tangents, partners pointing at
    other bodies; the state has M = n + m_extra rows."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    nrm = _unit(f32(3, R, n))
    helper = np.broadcast_to(np.asarray([1.0, 0.1, -0.2], np.float32)
                             [:, None, None], nrm.shape)
    t1 = _unit(np.cross(nrm, helper, axis=0))
    t2 = np.cross(nrm, t1, axis=0).astype(np.float32)
    m = n + m_extra
    rows = dict(
        partner=rng.integers(0, m, (R, n)).astype(np.int32),
        ra=f32(3, R, n) * 0.4, rb=f32(3, R, n) * 0.4,
        normal=nrm, t1=t1, t2=t2,
        friction=rng.uniform(0.2, 0.8, (R, n)).astype(np.float32),
        bias=rng.uniform(-0.5, 1.5, (R, n)).astype(np.float32),
        normal_mass=rng.uniform(0.2, 1.0, (R, n)).astype(np.float32),
        tangent_mass1=rng.uniform(0.2, 1.0, (R, n)).astype(np.float32),
        tangent_mass2=rng.uniform(0.2, 1.0, (R, n)).astype(np.float32),
        valid=rng.uniform(size=(R, n)) < valid_frac)
    body = dict(v=f32(3, m), omega=f32(3, m) * 0.3,
                inv_mass=rng.uniform(0.5, 1.5, m).astype(np.float32),
                iso=rng.uniform(0.5, 2.0, m).astype(np.float32))
    return rows, body


def _to(rows, body, vec, arr, RC):
    rc = RC(**{k: (vec(*(arr(np.ascontiguousarray(c)) for c in v))
                   if k in ("ra", "rb", "normal", "t1", "t2") else arr(v))
               for k, v in rows.items()})
    b = (vec(*(arr(np.ascontiguousarray(c)) for c in body["v"])),
         vec(*(arr(np.ascontiguousarray(c)) for c in body["omega"])),
         arr(body["inv_mass"]), arr(body["iso"]))
    return rc, b


def _both(rows, body):
    jrc, jb = _to(rows, body, JVec3, jnp.asarray, jsol.RowConstraints)
    trc, tb = _to(rows, body, TVec3, torch.as_tensor, tsol.RowConstraints)
    return (jrc, jb), (trc, tb)


def _np(x):
    if isinstance(x, tuple):
        return np.stack([_np(c) for c in x])
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _run(mod, rc, b, pallas, iters=3, inner=4, warm=None, ngr=None):
    return mod.solve_rows(rc, b[0], b[1], b[2], b[3], iters,
                          friction_mode="textbook", two_phase=False,
                          inner_iters=inner, warm=warm, return_acc=True,
                          n_gather_rows=ngr, pallas_inner=pallas)


def _assert_solve(out_j, out_t, valid, atol=2e-4):
    for a, b in zip(out_j[:2], out_t[:2]):
        np.testing.assert_allclose(_np(a), _np(b), atol=atol, rtol=1e-4)
    for a, b in zip(out_j[2], out_t[2]):
        np.testing.assert_allclose(_np(a)[valid], _np(b)[valid], atol=atol,
                                   rtol=1e-4)


@pytest.mark.parametrize("pallas", [False, True])
def test_solve_rows_matches_jax(pallas):
    rows, body = _random_rows()
    (jrc, jb), (trc, tb) = _both(rows, body)
    out_j = _run(jsol, jrc, jb, pallas)
    out_t = _run(tsol, trc, tb, pallas)
    _assert_solve(out_j, out_t, rows["valid"])
    # the solve must actually do something (non-degenerate fixture)
    assert np.abs(_np(out_t[0]) - body["v"]).max() > 1e-3


@pytest.mark.parametrize("pallas", [False, True])
def test_solve_rows_warm_started(pallas):
    rows, body = _random_rows(seed=3)
    rng = np.random.default_rng(9)
    R, n = rows["valid"].shape
    warm = [rng.uniform(0, 0.3, (R, n)).astype(np.float32) for _ in range(3)]
    (jrc, jb), (trc, tb) = _both(rows, body)
    out_j = _run(jsol, jrc, jb, pallas,
                 warm=tuple(jnp.asarray(w) for w in warm))
    out_t = _run(tsol, trc, tb, pallas,
                 warm=tuple(torch.as_tensor(w) for w in warm))
    _assert_solve(out_j, out_t, rows["valid"])


@pytest.mark.parametrize("pallas", [False, True])
def test_solve_rows_static_tail_rows(pallas):
    """n_gather_rows: trailing rows point at the static terminal row (zero
    velocity), are cut from the state gather, and still agree; the cut
    gather also equals the uncut one."""
    rows, body = _random_rows(seed=5)
    R, n = rows["valid"].shape
    ngr = R - 2
    rows["partner"][ngr:] = n
    body["v"][:, n] = 0.0
    body["omega"][:, n] = 0.0
    (jrc, jb), (trc, tb) = _both(rows, body)
    out_j = _run(jsol, jrc, jb, pallas, ngr=ngr)
    out_t = _run(tsol, trc, tb, pallas, ngr=ngr)
    _assert_solve(out_j, out_t, rows["valid"])
    out_f = _run(tsol, trc, tb, pallas, ngr=None)
    _assert_solve(out_t, out_f, rows["valid"])


def test_solve_rows_rejects_unsupported_modes():
    rows, body = _random_rows(n=64, R=2)
    _, (trc, tb) = _both(rows, body)
    with pytest.raises(ValueError):
        tsol.solve_rows(trc, tb[0], tb[1], tb[2], tb[3], 2, two_phase=True,
                        pallas_inner=True)
    # the reference's raw-lambda friction runs in the plain sweeps only
    v_m, _ = tsol.solve_rows(trc, tb[0], tb[1], tb[2], tb[3], 2,
                             friction_mode="mgf")
    assert all(bool(torch.isfinite(c).all()) for c in v_m)
    with pytest.raises(ValueError):
        tsol.solve_rows(trc, tb[0], tb[1], tb[2], tb[3], 2, two_phase=False,
                        friction_mode="mgf", pallas_inner=True)
    # Mat3 inertia runs in the plain sweeps, and the kernel, which is
    # scalar-inertia and whole-width, refuses it and a column offset
    iso = tb[3]
    z = torch.zeros_like(iso)
    mat = TMat3(iso, z, z, z, iso, z, z, z, iso)
    v_m, o_m = tsol.solve_rows(trc, tb[0], tb[1], tb[2], mat, 2)
    v_s, o_s = tsol.solve_rows(trc, tb[0], tb[1], tb[2], iso, 2)
    for a, b in zip((*v_m, *o_m), (*v_s, *o_s)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError):
        tsol.solve_rows(trc, tb[0], tb[1], tb[2], mat, 2, two_phase=False,
                        pallas_inner=True)
    with pytest.raises(ValueError):
        tsol.solve_rows(trc, tb[0], tb[1], tb[2], iso, 2, two_phase=False,
                        pallas_inner=True, col_offset=1)


@pytest.mark.parametrize("pallas", [False, True])
def test_invalid_rows_partner_out_of_range(pallas):
    """The fused path gathers partners from an N-row state while invalid
    pair rows carry partner = n (one past the end).  JAX clamps the index;
    the port must clamp explicitly (torch raises on CPU and is undefined on
    CUDA) and agree with JAX, the rows being masked by `valid`."""
    rows, body = _random_rows(n=300, R=5, seed=11, m_extra=0)
    R, n = rows["valid"].shape
    bad = np.random.default_rng(4).uniform(size=(R, n)) < 0.3
    rows["valid"] &= ~bad
    rows["partner"][bad] = n                     # past the N-row state
    (jrc, jb), (trc, tb) = _both(rows, body)
    out_j = _run(jsol, jrc, jb, pallas, ngr=R - 1)
    out_t = _run(tsol, trc, tb, pallas, ngr=R - 1)
    _assert_solve(out_j, out_t, rows["valid"])
    assert all(np.isfinite(_np(o)).all() for o in out_t[:2])


def test_inner_sweeps_reference_matches_pallas_kernel():
    """K1's plain version against the Pallas kernel itself (interpret
    mode) on one outer iteration's inputs."""
    from mgf_tpu.ops import solver_sweep as jss
    rows, body = _random_rows(n=512, R=12, seed=13)
    (jrc, _), (trc, _) = _both(rows, body)
    rng = np.random.default_rng(1)
    n = 512
    S = rng.standard_normal((8, n)).astype(np.float32)
    term = (rng.standard_normal((3, 12, n)) * 0.5).astype(np.float32)
    self_p = rng.uniform(0.5, 1.5, (2, n)).astype(np.float32)
    acc = rng.uniform(0, 0.3, (3, 12, n)).astype(np.float32)
    fj = jss.pack_row_fields(jrc)
    ft = tss.pack_row_fields(trc)
    np.testing.assert_array_equal(np.asarray(fj), ft.numpy())
    for inner in (4, 6):
        sj, aj = jss.inner_sweeps(jnp.asarray(S), fj, jnp.asarray(term),
                                  jnp.asarray(self_p), jnp.asarray(acc),
                                  inner, interpret=True)
        st, at = tss.inner_sweeps(torch.as_tensor(S), ft,
                                  torch.as_tensor(term),
                                  torch.as_tensor(self_p),
                                  torch.as_tensor(acc), inner)
        np.testing.assert_allclose(np.asarray(sj), st.numpy(), atol=2e-4,
                                   rtol=1e-4)
        # the kernel masks accumulator updates itself: compare everywhere
        np.testing.assert_allclose(np.asarray(aj), at.numpy(), atol=2e-4,
                                   rtol=1e-4)
        np.testing.assert_array_equal(st.numpy()[6:], S[6:])


def test_inner_sweeps_checks_inputs():
    n, R = 16, 3
    z = lambda *s: torch.zeros(s, dtype=torch.float32)
    ok = (z(8, n), z(18, R, n), z(3, R, n), z(2, n), z(3, R, n))
    tss.inner_sweeps(*ok, 2)
    with pytest.raises(ValueError):
        tss.inner_sweeps(z(8, n), z(18, R, n + 1), *ok[2:], 2)
    with pytest.raises(TypeError):
        tss.inner_sweeps(ok[0].double(), *ok[1:], 2)
    with pytest.raises(ValueError):
        tss.inner_sweeps(z(n, 8).T, *ok[1:], 2)


def test_build_row_constraints_iso_fused_matches_jax():
    rng = np.random.default_rng(21)
    n, K, T = 400, 9, 3
    R = K + T
    f32 = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    uni = lambda lo, hi, *s: rng.uniform(lo, hi, s).astype(np.float32)
    body = dict(x=f32(3, n, sc=3.0), v=f32(3, n), omega=f32(3, n, sc=0.3),
                restitution=uni(0.0, 0.5, n), friction=uni(0.2, 0.8, n),
                inv_mass=uni(0.5, 1.5, n), iso=uni(0.5, 2.0, n))
    pfd = dict(x_end=f32(3, K, n, sc=3.0), v=f32(3, K, n),
               omega=f32(3, K, n, sc=0.3), restitution=uni(0, 0.5, K, n),
               friction=uni(0.2, 0.8, K, n), inv_mass=uni(0.5, 1.5, K, n),
               count=np.floor(uni(1, 8, K, n)), iso=uni(0.5, 2.0, K, n))
    counts = np.floor(uni(1, 8, n))
    nrm = _unit(f32(3, R, n))
    t1 = _unit(np.cross(nrm, np.asarray([1.0, 0.1, -0.2], np.float32)
                        [:, None, None] + 0 * nrm, axis=0))
    t2 = np.cross(nrm, t1, axis=0).astype(np.float32)
    man = dict(time=uni(0, 1, R, n), normal=nrm, t1=t1, t2=t2,
               local_a=f32(3, R, n, sc=0.5), local_b=f32(3, R, n, sc=0.5),
               valid=rng.uniform(size=(R, n)) < 0.6)
    partner = rng.integers(0, n + 1, (R, n)).astype(np.int32)
    static_x = np.asarray([0.0, -10.0, 0.0], np.float32)

    def build(mod, Vec, Mat, arr, Man):
        vec = lambda a: Vec(*(arr(np.ascontiguousarray(c)) for c in a))
        iso = arr(body["iso"])
        z = arr(np.zeros(n, np.float32))
        bv = mod.BodyView(x=vec(body["x"]), v=vec(body["v"]),
                          omega=vec(body["omega"]),
                          restitution=arr(body["restitution"]),
                          friction=arr(body["friction"]),
                          inv_mass=arr(body["inv_mass"]),
                          inv_moment=Mat(iso, z, z, z, iso, z, z, z, iso))
        pf = mod.PartnerFields(**{k: (vec(v) if v.ndim == 3 else arr(v))
                                  for k, v in pfd.items()})
        m = Man(**{k: (vec(v) if v.ndim == 3 else arr(v))
                   for k, v in man.items()})
        return mod.build_row_constraints_iso_fused(
            bv, arr(counts), pf, arr(partner), m, 1.0 / 60.0,
            vec(static_x), K)

    rj = build(jsol, JVec3, JMat3, jnp.asarray, JManifold)
    rt = build(tsol, TVec3, TMat3, torch.as_tensor, TManifold)
    for f in rj._fields:
        a, b = _np(getattr(rj, f)), _np(getattr(rt, f))
        if a.dtype == bool or f == "partner":
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5,
                                       err_msg=f)


@pytest.mark.parametrize("warm,inner", [(False, 4), (True, 1), (True, 6)])
def test_inner_sweeps_gather_reference_matches_jax(warm, inner):
    """K1's gather mode (plain version) against mgf_tpu on one outer
    iteration: solve_rows' partner term (mgf_tpu/solver.py partner_term)
    and the Pallas inner_sweeps in interpret mode, through mgf_tpu's
    solve_rows with iters=1.  The state has statics past N (M > N), some
    invalid rows point one past the end (partner = M), and the last rows
    have a static partner (K < R).  With ``warm``, mgf_tpu's solve_rows
    with iters=0 gives the state and accumulators after its warm pre-apply,
    which are this iteration's inputs."""
    rows, body = _random_rows(n=600, R=8, seed=17, m_extra=5)
    R, n = rows["valid"].shape
    m = n + 5
    K = R - 3
    bad = np.random.default_rng(6).uniform(size=(R, n)) < 0.3
    rows["valid"] &= ~bad
    rows["partner"][bad] = m                     # past the (8, M) state
    (jrc, jb), _ = _both(rows, body)
    rng = np.random.default_rng(8)
    w = (tuple(jnp.asarray(rng.uniform(0, 0.3, (R, n)).astype(np.float32))
               for _ in range(3)) if warm else None)
    run = lambda iters: jsol.solve_rows(
        jrc, jb[0], jb[1], jb[2], jb[3], iters, friction_mode="textbook",
        two_phase=False, inner_iters=inner, warm=w, return_acc=True,
        n_gather_rows=K, pallas_inner=True)
    v0, o0, acc0 = run(0)
    v1, o1, acc1 = run(1)
    S = np.zeros((8, m), np.float32)
    S[:3], S[3:6] = _np(v0), _np(o0)
    trc = _both(rows, body)[1][0]
    args = (torch.as_tensor(S), tss.pack_row_fields(trc),
            torch.as_tensor(rows["partner"]),
            torch.as_tensor(np.ascontiguousarray(rows["rb"][:, :K])),
            torch.as_tensor(np.stack([body["inv_mass"][:n], body["iso"][:n]])),
            torch.as_tensor(_np(acc0)))
    s_t, a_t = tss.inner_sweeps_gather_reference(*args, inner, K)
    np.testing.assert_allclose(s_t.numpy()[:3], _np(v1), atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(s_t.numpy()[3:6], _np(o1), atol=2e-4,
                               rtol=1e-4)
    np.testing.assert_array_equal(s_t.numpy()[:, n:], S[:, n:])
    np.testing.assert_array_equal(s_t.numpy()[6:], 0.0)
    valid = rows["valid"]
    np.testing.assert_allclose(a_t.numpy()[:, valid], _np(acc1)[:, valid],
                               atol=2e-4, rtol=1e-4)
    # the wrapper on CPU tensors is the plain version, and counts nothing
    before = tss.LAUNCHES
    s_w, a_w = tss.inner_sweeps_gather(*args, inner, K)
    assert torch.equal(s_w, s_t) and torch.equal(a_w, a_t)
    assert tss.LAUNCHES == before
    # the solve must actually do something (non-degenerate fixture)
    assert np.abs(s_t.numpy()[:3] - S[:3]).max() > 1e-3


def test_inner_sweeps_gather_checks_inputs():
    n, R, K, m = 16, 3, 2, 20
    z = lambda *s: torch.zeros(s, dtype=torch.float32)
    part = torch.zeros((R, n), dtype=torch.int32)
    ok = (z(8, m), z(18, R, n), part, z(3, K, n), z(2, n), z(3, R, n))
    s_out, a_out = tss.inner_sweeps_gather(*ok, 2, K)
    assert s_out.shape == (8, m) and a_out.shape == (3, R, n)
    tss.inner_sweeps_gather(z(8, n), *ok[1:3], z(3, 0, n), *ok[4:], 2, 0)
    with pytest.raises(TypeError):                     # partner int64
        tss.inner_sweeps_gather(ok[0], ok[1], part.long(), *ok[3:], 2, K)
    with pytest.raises(ValueError):                    # rb rows != K
        tss.inner_sweeps_gather(*ok[:3], z(3, K + 1, n), *ok[4:], 2, K)
    with pytest.raises(ValueError):                    # K > R
        tss.inner_sweeps_gather(*ok[:3], z(3, R + 1, n), *ok[4:], 2, R + 1)
    with pytest.raises(ValueError):                    # M < N
        tss.inner_sweeps_gather(z(8, n - 1), *ok[1:], 2, K)
    with pytest.raises(ValueError):                    # partner not (R, N)
        tss.inner_sweeps_gather(ok[0], ok[1], part[:, :8], *ok[3:], 2, K)
    with pytest.raises(ValueError):                    # non-contiguous
        tss.inner_sweeps_gather(z(m, 8).T, *ok[1:], 2, K)


def test_sweep_kernel_limits():
    """A CUDA block is 32 columns x R rows: R = 33 is refused on every
    device, as is a K3 block width that is not a multiple of 32 (unless
    it is the whole width)."""
    n = 64
    z = lambda *s: torch.zeros(s, dtype=torch.float32)
    for R, ok in ((32, True), (33, False)):
        args = (z(8, n), z(18, R, n), z(3, R, n), z(2, n), z(3, R, n))
        gargs = (z(8, n), z(18, R, n), torch.zeros((R, n), dtype=torch.int32),
                 z(3, 1, n), z(2, n), z(3, R, n))
        if ok:
            tss.inner_sweeps(*args, 1)
            tss.inner_sweeps_gather(*gargs, 1, 1)
            continue
        with pytest.raises(ValueError):
            tss.inner_sweeps(*args, 1)
        with pytest.raises(ValueError):
            tss.inner_sweeps_gather(*gargs, 1, 1)
    blk = lambda nb, b: (z(nb, 8, b), z(nb, 18, 2, b), z(nb, 3, 2, b),
                         z(nb, 2, b), z(nb, 3, 2, b))
    tss.inner_sweeps_blockmajor(*blk(2, 64), 1)
    tss.inner_sweeps_blockmajor(*blk(1, 48), 1)
    with pytest.raises(ValueError):
        tss.inner_sweeps_blockmajor(*blk(2, 48), 1)


# ---- Mat3 inertia, column blocks (col_offset / state0 / return_state) ----

def _mat3_system(seed, m=501, ns=300, R=8, bias_max=-1.0):
    """Random bodies with symmetric positive-definite inverse inertia (the
    last of the M rows is the static terrain row: zero inverse mass and
    inertia), and a random (R, M - 1) manifold whose partners point at any
    of the M rows.  Columns [0, ns) stand for spheres (isotropic inertia),
    [ns, M - 1) for capsules."""
    rng = np.random.default_rng(seed)
    n = m - 1
    f32 = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    uni = lambda lo, hi, *s: rng.uniform(lo, hi, s).astype(np.float32)
    L = f32(n, 3, 3, sc=0.4) + np.eye(3, dtype=np.float32)
    I = np.einsum("nij,nkj->nik", L, L).astype(np.float32)
    iso = uni(0.5, 2.0, ns)
    I[:ns] = iso[:, None, None] * np.eye(3, dtype=np.float32)
    I = np.concatenate([I, np.zeros((1, 3, 3), np.float32)])
    stat = lambda a: np.concatenate([a, np.zeros(a.shape[:-1] + (1,),
                                                 np.float32)], axis=-1)
    body = dict(x=f32(3, m, sc=3.0), v=stat(f32(3, n)),
                omega=stat(f32(3, n, sc=0.3)),
                restitution=stat(uni(0.0, 0.5, n)),
                friction=stat(uni(0.2, 0.8, n)),
                inv_mass=stat(uni(0.5, 1.5, n)), I=I)
    nrm = _unit(f32(3, R, n))
    t1 = _unit(np.cross(nrm, np.asarray([1.0, 0.1, -0.2], np.float32)
                        [:, None, None] + 0 * nrm, axis=0))
    t2 = np.cross(nrm, t1, axis=0).astype(np.float32)
    man = dict(time=uni(0, 1, R, n), normal=nrm, t1=t1, t2=t2,
               local_a=f32(3, R, n, sc=0.5), local_b=f32(3, R, n, sc=0.5),
               valid=rng.uniform(size=(R, n)) < 0.6)
    partner = rng.integers(0, m, (R, n)).astype(np.int32)
    counts = np.maximum(np.concatenate(
        [man["valid"].sum(0), [1]]), 1).astype(np.float32)
    warm = [uni(0, 0.2, R, n) for _ in range(3)]
    return body, man, partner, counts, warm, bias_max


def _mat3_side(mod, Vec, Mat, arr, Man, body):
    c = lambda a: arr(np.ascontiguousarray(a))
    vec = lambda a: Vec(*(c(x) for x in a))
    I = body["I"]
    bv = mod.BodyView(x=vec(body["x"]), v=vec(body["v"]),
                      omega=vec(body["omega"]),
                      restitution=c(body["restitution"]),
                      friction=c(body["friction"]),
                      inv_mass=c(body["inv_mass"]),
                      inv_moment=Mat(*(c(I[:, i, j]) for i in range(3)
                                       for j in range(3))))
    mk_man = lambda man, cols: Man(**{
        k: (vec(v[..., cols]) if v.ndim == 3 else c(v[..., cols]))
        for k, v in man.items()})
    return bv, mk_man, c


_SIDES = [(jsol, JVec3, JMat3, jnp.asarray, JManifold),
          (tsol, TVec3, TMat3, torch.as_tensor, TManifold)]


@pytest.mark.parametrize("lo,hi,bias_max", [(0, 500, -1.0), (300, 500, -1.0),
                                            (0, 300, 2.0)])
def test_build_row_constraints_matches_jax(lo, hi, bias_max):
    """The Mat3 constraint build over a column block [lo, hi), with mass
    splitting and the bias clamp: masks and partners exact, floats atol
    1e-5 + rtol 1e-5."""
    body, man, partner, counts, _, _ = _mat3_system(31)
    cols = slice(lo, hi)
    out = []
    for mod, Vec, Mat, arr, Man in _SIDES:
        bv, mk_man, c = _mat3_side(mod, Vec, Mat, arr, Man, body)
        out.append(mod.build_row_constraints(
            bv, c(partner[:, cols]), mk_man(man, cols), 1.0 / 60.0,
            counts=c(counts), col_offset=lo, bias_max=bias_max))
    rj, rt = out
    for f in rj._fields:
        a, b = _np(getattr(rj, f)), _np(getattr(rt, f))
        if a.dtype == bool or f == "partner":
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5,
                                       err_msg=f)
    if bias_max >= 0.0:
        assert _np(rt.bias).max() > 1.0       # the clamp left restitution


def test_solve_rows_mat3_cold_two_phase_20():
    """The capsules demo's solve: cold, 20 two-phase sweeps, Mat3 inertia
    over all columns.  v, omega atol 2e-4 (rtol 1e-4), accumulators on
    valid rows."""
    body, man, partner, counts, _, _ = _mat3_system(32)
    cols = slice(0, 500)
    out = []
    for mod, Vec, Mat, arr, Man in _SIDES:
        bv, mk_man, c = _mat3_side(mod, Vec, Mat, arr, Man, body)
        rc = mod.build_row_constraints(bv, c(partner), mk_man(man, cols),
                                       1.0 / 60.0, counts=c(counts))
        out.append(mod.solve_rows(rc, bv.v, bv.omega, bv.inv_mass,
                                  bv.inv_moment, 20, "textbook", True, 1,
                                  return_acc=True))
    _assert_solve(out[0], out[1], man["valid"])
    assert np.isfinite(_np(out[1][0])).all()
    assert np.abs(_np(out[1][1]) - body["omega"]).max() > 1e-3
    # the static row never moves
    assert np.abs(_np(out[1][0])[:, -1]).max() == 0.0


def test_solve_rows_split_blocks_chain():
    """The mixed pile's solve: warm, single-phase 4 x 4; the sphere block
    (scalar inertia, columns [0, ns)) returns the packed state, the capsule
    block (Mat3, ``col_offset=ns``) starts from it through ``state0``, so
    its partner gathers read the sphere block's solved velocities.  Packed
    state atol 2e-4 (rtol 1e-4), accumulators on valid rows."""
    ns = 300
    body, man, partner, counts, warm, _ = _mat3_system(33, ns=ns)
    A, B = slice(0, ns), slice(ns, 500)
    out = []
    for mod, Vec, Mat, arr, Man in _SIDES:
        bv, mk_man, c = _mat3_side(mod, Vec, Mat, arr, Man, body)
        rc_a = mod.build_row_constraints(bv, c(partner[:, A]),
                                         mk_man(man, A), 1.0 / 60.0,
                                         counts=c(counts))
        rc_b = mod.build_row_constraints(bv, c(partner[:, B]),
                                         mk_man(man, B), 1.0 / 60.0,
                                         counts=c(counts), col_offset=ns)
        S1, acc_a = mod.solve_rows(
            rc_a, bv.v, bv.omega, bv.inv_mass, bv.inv_moment.xx, 4,
            "textbook", False, 4, warm=tuple(c(w[:, A]) for w in warm),
            return_acc=True, return_state=True)
        S2, acc_b = mod.solve_rows(
            rc_b, bv.v, bv.omega, bv.inv_mass, bv.inv_moment, 4,
            "textbook", False, 4, warm=tuple(c(w[:, B]) for w in warm),
            return_acc=True, state0=S1, return_state=True, col_offset=ns)
        out.append((S1, acc_a, S2, acc_b))
    (j1, ja, j2, jb), (t1, ta, t2, tb) = out
    assert _np(t2).shape == (8, 501)
    for a, b in ((j1, t1), (j2, t2)):
        np.testing.assert_allclose(_np(a), _np(b), atol=2e-4, rtol=1e-4)
    for accs_j, accs_t, cols in ((ja, ta, A), (jb, tb, B)):
        v = man["valid"][:, cols]
        for a, b in zip(accs_j, accs_t):
            np.testing.assert_allclose(_np(a)[v], _np(b)[v], atol=2e-4,
                                       rtol=1e-4)
    # block B left block A's columns as block A solved them, and moved its own
    np.testing.assert_array_equal(_np(t2)[:, :ns], _np(t1)[:, :ns])
    assert np.abs(_np(t2)[:6, ns:500] - _np(t1)[:6, ns:500]).max() > 1e-3
    # and it read them: the same block solved from the pre-solve state differs
    bv, mk_man, c = _mat3_side(*_SIDES[1], body)
    rc_b = tsol.build_row_constraints(bv, c(partner[:, B]), mk_man(man, B),
                                      1.0 / 60.0, counts=c(counts),
                                      col_offset=ns)
    S_alone = tsol.solve_rows(
        rc_b, bv.v, bv.omega, bv.inv_mass, bv.inv_moment, 4, "textbook",
        False, 4, warm=tuple(c(w[:, B]) for w in warm), return_state=True,
        col_offset=ns)
    assert np.abs(_np(S_alone)[:6, ns:500] - _np(t2)[:6, ns:500]).max() > 1e-3

"""Fused row-solver inner sweeps: the hand-written CUDA kernel K1.

Counterpart of ``mgf_tpu/ops/solver_sweep.py`` (the Pallas TPU kernel
``inner_sweeps``) and of the partner-state gather ``solve_rows`` runs before
each call.  ``solve_rows`` freezes the partner velocity term for each OUTER
iteration and runs ``inner_iters`` block-Jacobi sweeps that update only
each body's own velocity, so within an outer iteration the body columns are
independent.  The kernel (``csrc/solver_sweep.cu``) runs a CUDA block of
32 columns x R rows, one thread per (row, column): each thread keeps its
row's channels in registers across all sweeps, and the rows of a column
meet in shared memory to sum their impulses.

Two modes of the one kernel:

* :func:`inner_sweeps` takes the frozen (3, R, N) partner term;
* :func:`inner_sweeps_gather` forms it inside the kernel from the full
  (8, M) state, the (R, N) row partners and the (3, K, N) partner contact
  points (rows >= K have a static partner and term 0), and returns the
  full (8, M) state: one launch per outer iteration.

Each launches the kernel for CUDA tensors and runs its plain PyTorch
version for CPU tensors: :func:`inner_sweeps_reference` mirrors the Pallas
body line for line; :func:`inner_sweeps_gather_reference` is
:func:`partner_term` (``solve_rows``' clamp, row-major gather and zero tail
rows), then :func:`inner_sweeps_reference`, then the state's columns past
N.  Nothing else selects between them: a CUDA call that cannot build or
launch the kernel raises.  R is 1..32 (a CUDA block of 32 x R threads).

Channel layout of the packed (18, R, N) constraint tensor (see
:func:`pack_row_fields`): normal(3) t1(3) t2(3) ra(3), then friction, bias,
normal_mass, tangent_mass1, tangent_mass2, valid.

:func:`inner_sweeps_blockmajor` runs the term mode over the block-major
layout (nb, C, R, block) of ``scripts/micro_sweep.py::run_blockmajor``
(kernel K3): the kernel takes the block width as a stride (a multiple of
32, or N), and the (C, R, N) layout is the case block = N.  It is off the
step path.
"""

from __future__ import annotations

import ctypes

import torch

from mgf_tpu_torch.ops import _build, launches

_NCH = 18
MAX_ROWS = 32     # a CUDA block is 32 columns x R rows, at most 1024 threads
_TILE = 32        # columns per CUDA block; K3's block width is a multiple

# kernel launches made by inner_sweeps and inner_sweeps_gather (LAUNCHES)
# and by inner_sweeps_blockmajor (BLOCKMAJOR_LAUNCHES) in this process (read
# and reset by callers that must show the main path went through the kernel)
LAUNCHES = 0
BLOCKMAJOR_LAUNCHES = 0


def pack_row_fields(rc) -> torch.Tensor:
    """Stack the RowConstraints channels the sweep reads into one
    (18, R, N) float32 tensor (built once per step; the kernel reads it
    once per outer iteration)."""
    return torch.stack([
        rc.normal.x, rc.normal.y, rc.normal.z,
        rc.t1.x, rc.t1.y, rc.t1.z,
        rc.t2.x, rc.t2.y, rc.t2.z,
        rc.ra.x, rc.ra.y, rc.ra.z,
        rc.friction, rc.bias, rc.normal_mass,
        rc.tangent_mass1, rc.tangent_mass2, rc.valid.to(torch.float32),
    ], dim=0)


def partner_index(partner, n_gather_rows: int, n_state: int):
    """The leading ``n_gather_rows`` rows of the (R, N) partner matrix as
    gather indices into an ``n_state``-column state.  JAX clamps
    out-of-range gather indices; invalid pair rows carry partner = N, which
    lies past an N-column state, so clamp explicitly (the rows are masked
    by ``valid`` afterwards)."""
    return torch.clamp(partner[:n_gather_rows], 0, n_state - 1).long()


def partner_term(S, index, rb, n_rows: int):
    """The frozen partner term vb + ob x rb of one outer iteration as three
    (R, N) tensors.  ``index`` (K, N) from :func:`partner_index`; ``rb``
    the (K, N) partner contact points (a Vec3 or a (3, K, N) tensor); rows
    K..R-1 have a static partner and term 0."""
    g = S.T[index]                  # (K, N, 8): one contiguous row per index
    rbx, rby, rbz = rb
    term = (g[..., 0] + (g[..., 4] * rbz - g[..., 5] * rby),
            g[..., 1] + (g[..., 5] * rbx - g[..., 3] * rbz),
            g[..., 2] + (g[..., 3] * rby - g[..., 4] * rbx))
    pad = n_rows - index.shape[0]
    if pad:
        zt = torch.zeros((pad, index.shape[1]), dtype=S.dtype,
                         device=S.device)
        term = tuple(torch.cat([c, zt], dim=0) for c in term)
    return term


def inner_sweeps_reference(S, fields, term, self_p, acc, inner_iters: int):
    """The plain PyTorch version of the kernel: the Pallas body
    (``mgf_tpu/ops/solver_sweep.py::_kernel``) transcribed op for op."""
    f = fields
    nx, ny, nz = f[0], f[1], f[2]
    t1x, t1y, t1z = f[3], f[4], f[5]
    t2x, t2y, t2z = f[6], f[7], f[8]
    rax, ray, raz = f[9], f[10], f[11]
    fric, bias, nm = f[12], f[13], f[14]
    tm1, tm2, valid = f[15], f[16], f[17]
    tx, ty, tz = term[0], term[1], term[2]
    ima, ia_s = self_p[0], self_p[1]
    vax, vay, vaz, oax, oay, oaz = S[0], S[1], S[2], S[3], S[4], S[5]
    acc_n, acc_t1, acc_t2 = acc[0], acc[1], acc[2]
    live = valid > 0.0
    for _ in range(inner_iters):
        # dv = frozen partner term - (va + oa x ra), broadcast (N,)->(R,N)
        dvx = tx - (vax + oay * raz - oaz * ray)
        dvy = ty - (vay + oaz * rax - oax * raz)
        dvz = tz - (vaz + oax * ray - oay * rax)
        # friction first (single-phase: both from the same dv)
        lam1 = -(dvx * t1x + dvy * t1y + dvz * t1z) * tm1
        lam2 = -(dvx * t2x + dvy * t2y + dvz * t2z) * tm2
        max_l = fric * acc_n
        new1 = torch.minimum(torch.maximum(acc_t1 + lam1, -max_l), max_l)
        new2 = torch.minimum(torch.maximum(acc_t2 + lam2, -max_l), max_l)
        f1 = new1 - acc_t1
        f2 = new2 - acc_t2
        # projected normal impulse from the same dv
        vn = dvx * nx + dvy * ny + dvz * nz
        lam = nm * (bias - vn)
        new_n = torch.clamp(acc_n + lam, min=0.0)
        fn = new_n - acc_n
        # composite impulse, masked by row validity
        ix = (t1x * f1 + t2x * f2 + nx * fn) * valid
        iy = (t1y * f1 + t2y * f2 + ny * fn) * valid
        iz = (t1z * f1 + t2z * f2 + nz * fn) * valid
        # the body is side a: it receives -impulse; reduce over rows
        vax = vax + -torch.sum(ix, dim=0) * ima
        vay = vay + -torch.sum(iy, dim=0) * ima
        vaz = vaz + -torch.sum(iz, dim=0) * ima
        oax = oax + -torch.sum(ray * iz - raz * iy, dim=0) * ia_s
        oay = oay + -torch.sum(raz * ix - rax * iz, dim=0) * ia_s
        oaz = oaz + -torch.sum(rax * iy - ray * ix, dim=0) * ia_s
        acc_n = torch.where(live, new_n, acc_n)
        acc_t1 = torch.where(live, new1, acc_t1)
        acc_t2 = torch.where(live, new2, acc_t2)
    s_out = torch.stack([vax, vay, vaz, oax, oay, oaz, S[6], S[7]], dim=0)
    return s_out, torch.stack([acc_n, acc_t1, acc_t2], dim=0)


def inner_sweeps_gather_reference(S, fields, partner, rb, self_p, acc,
                                  inner_iters: int, n_gather_rows: int):
    """The plain version of :func:`inner_sweeps_gather`: the partner term
    as ``solve_rows`` forms it, :func:`inner_sweeps_reference` on the first
    N state columns, and the columns past N as they were."""
    R, n = partner.shape
    idx = partner_index(partner, n_gather_rows, S.shape[1])
    term = torch.stack(partner_term(S, idx, rb, R))
    s_out, acc_out = inner_sweeps_reference(S[:, :n], fields, term, self_p,
                                            acc, inner_iters)
    return torch.cat([s_out, S[:, n:]], dim=1), acc_out


def _check(device, specs):
    """``specs``: (name, tensor, shape, dtype) for every input; each must
    have that shape and dtype, lie on ``device`` and be contiguous."""
    for name, t, shape, dtype in specs:
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, "
                             f"got {tuple(t.shape)}")
    for name, t, shape, dtype in specs:
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, not {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _rows(fields, lead=()):
    """(R, N) from fields of shape lead + (18, R, N); R must be 1..32."""
    L = len(lead)
    if (fields.dim() != L + 3 or tuple(fields.shape[:L]) != tuple(lead)
            or fields.shape[L] != _NCH):
        raise ValueError(f"fields must be {tuple(lead) + (18, 'R', 'N')}, "
                         f"got {tuple(fields.shape)}")
    R, n = fields.shape[L + 1], fields.shape[L + 2]
    if not 1 <= R <= MAX_ROWS:
        raise ValueError(f"the kernel takes 1..{MAX_ROWS} rows, got R = {R}")
    return R, n


def _check_term(S, fields, term, self_p, acc, lead=()):
    """Shapes lead + (8, N), lead + (18, R, N) ...; ``lead`` is (nb,) for
    the block-major layout."""
    R, n = _rows(fields, lead)
    f32 = torch.float32
    _check(S.device, [("S", S, lead + (8, n), f32),
                      ("fields", fields, lead + (_NCH, R, n), f32),
                      ("term", term, lead + (3, R, n), f32),
                      ("self_p", self_p, lead + (2, n), f32),
                      ("acc", acc, lead + (3, R, n), f32)])


def _lib():
    lib = _build.load("solver_sweep")
    term = lib.mgf_solver_sweep
    term.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    term.restype = ctypes.c_int
    gather = lib.mgf_solver_sweep_gather
    gather.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    gather.restype = ctypes.c_int
    return term, gather


def _cuda(S, name):
    if S.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {S.device}")
    return torch.cuda.current_stream(S.device).cuda_stream


def _raise_on(err):
    if err != 0:
        raise RuntimeError(f"solver_sweep kernel launch failed: cudaError "
                           f"{err}")


def _launch(S, fields, term, self_p, acc, inner_iters: int, block: int):
    stream = _cuda(S, "inner_sweeps")
    fn, _ = _lib()
    s_out = torch.empty_like(S)
    acc_out = torch.empty_like(acc)
    n_cols = S.numel() // 8
    _raise_on(fn(S.data_ptr(), fields.data_ptr(), term.data_ptr(),
                 self_p.data_ptr(), acc.data_ptr(), s_out.data_ptr(),
                 acc_out.data_ptr(), n_cols, fields.shape[-2],
                 int(inner_iters), int(block), stream))
    return s_out, acc_out


def inner_sweeps(S, fields, term, self_p, acc, inner_iters: int):
    """Run ``inner_iters`` fused block-Jacobi inner sweeps.

    S        (8, N)  packed body state (rows vx vy vz ox oy oz _ _)
    fields   (18, R, N) from :func:`pack_row_fields`, R in 1..32
    term     (3, R, N) frozen partner term (vb + ob x rb)
    self_p   (2, N)  [inv_mass, iso inverse inertia]
    acc      (3, R, N) accumulated impulses (n, t1, t2)

    Returns new (S', acc') tensors.  Any N works (the kernel masks the
    ragged edge).  CUDA tensors launch the kernel; CPU tensors run
    :func:`inner_sweeps_reference`.
    """
    _check_term(S, fields, term, self_p, acc)
    if S.device.type == "cpu":
        return inner_sweeps_reference(S, fields, term, self_p, acc,
                                      inner_iters)
    out = _launch(S, fields, term, self_p, acc, inner_iters, S.shape[1])
    launches.count(__name__, "LAUNCHES")
    return out


def inner_sweeps_gather(S, fields, partner, rb, self_p, acc,
                        inner_iters: int, n_gather_rows: int):
    """:func:`inner_sweeps` with the partner term formed in the kernel.

    S        (8, M)  the full packed state, M >= N (statics past N)
    fields   (18, R, N) from :func:`pack_row_fields`, R in 1..32
    partner  (R, N)  int32 row partner (column of S; clamped into [0, M))
    rb       (3, K, N) partner contact points of rows [0, K), K =
             ``n_gather_rows`` <= R; rows K..R-1 have term 0
    self_p   (2, N), acc (3, R, N) as for :func:`inner_sweeps`

    The term is read from ``S`` as it comes in.  Returns (S', acc') with S'
    (8, M): columns [0, N) swept, columns past N copied.  CUDA tensors
    launch the kernel; CPU tensors run
    :func:`inner_sweeps_gather_reference`.
    """
    R, n = _rows(fields)
    K = int(n_gather_rows)
    if not 0 <= K <= R:
        raise ValueError(f"n_gather_rows must be in [0, {R}], got {K}")
    if S.dim() != 2 or S.shape[1] < max(n, 1):
        raise ValueError(f"S must be (8, M) with M >= max(N, 1) = "
                         f"{max(n, 1)}, got {tuple(S.shape)}")
    f32 = torch.float32
    _check(S.device, [("S", S, (8, S.shape[1]), f32),
                      ("fields", fields, (_NCH, R, n), f32),
                      ("partner", partner, (R, n), torch.int32),
                      ("rb", rb, (3, K, n), f32),
                      ("self_p", self_p, (2, n), f32),
                      ("acc", acc, (3, R, n), f32)])
    if S.device.type == "cpu":
        return inner_sweeps_gather_reference(S, fields, partner, rb, self_p,
                                             acc, inner_iters, K)
    stream = _cuda(S, "inner_sweeps_gather")
    _, fn = _lib()
    s_out = torch.empty_like(S)
    acc_out = torch.empty_like(acc)
    _raise_on(fn(S.data_ptr(), fields.data_ptr(), partner.data_ptr(),
                 rb.data_ptr(), self_p.data_ptr(), acc.data_ptr(),
                 s_out.data_ptr(), acc_out.data_ptr(), n, R,
                 int(inner_iters), S.shape[1], K, stream))
    launches.count(__name__, "LAUNCHES")
    return s_out, acc_out


def _to_cols(x):
    """(nb, C, [R,] block) -> (C, [R,] nb * block)."""
    nb, block = x.shape[0], x.shape[-1]
    return x.movedim(0, -2).reshape(*x.shape[1:-1], nb * block)


def _to_blocks(x, nb):
    """(C, [R,] nb * block) -> (nb, C, [R,] block)."""
    block = x.shape[-1] // nb
    return x.reshape(*x.shape[:-1], nb, block).movedim(-2, 0).contiguous()


def inner_sweeps_blockmajor_reference(S, fields, term, self_p, acc,
                                      inner_iters: int):
    """The plain version of the block-major sweeps: re-lay the tensors out
    as (C, R, N), run :func:`inner_sweeps_reference`, lay the result back
    out in blocks."""
    nb = S.shape[0]
    s_out, acc_out = inner_sweeps_reference(
        *(_to_cols(x) for x in (S, fields, term, self_p, acc)), inner_iters)
    return _to_blocks(s_out, nb), _to_blocks(acc_out, nb)


def inner_sweeps_blockmajor(S, fields, term, self_p, acc, inner_iters: int):
    """:func:`inner_sweeps` over the block-major layout: S (nb, 8, block),
    fields (nb, 18, R, block), term (nb, 3, R, block), self_p
    (nb, 2, block), acc (nb, 3, R, block); column j of block b is body
    b * block + j.  ``block`` is a multiple of 32 unless nb = 1.  Returns
    (S', acc') in the same layout.  CUDA tensors launch the kernel with a
    block stride; CPU tensors run :func:`inner_sweeps_blockmajor_reference`.
    """
    nb, block = S.shape[0], S.shape[-1]
    _check_term(S, fields, term, self_p, acc, lead=(nb,))
    if nb > 1 and block % _TILE:
        raise ValueError(f"block must be a multiple of {_TILE} (or the "
                         f"whole width), got {block}")
    if S.device.type == "cpu":
        return inner_sweeps_blockmajor_reference(S, fields, term, self_p,
                                                 acc, inner_iters)
    out = _launch(S, fields, term, self_p, acc, inner_iters, block)
    launches.count(__name__, "BLOCKMAJOR_LAUNCHES")
    return out

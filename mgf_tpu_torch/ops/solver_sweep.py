"""Fused row-solver inner sweeps: the hand-written CUDA kernel K1.

Counterpart of ``mgf_tpu/ops/solver_sweep.py`` (the Pallas TPU kernel
``inner_sweeps``).  ``solve_rows`` freezes the partner velocity term for each
OUTER iteration and runs ``inner_iters`` block-Jacobi sweeps that update only
each body's own velocity, so within an outer iteration the body columns are
independent.  The kernel (``csrc/solver_sweep.cu``) runs one thread per
column with the sweep loop in the thread.

:func:`inner_sweeps` launches the kernel for CUDA tensors and runs
:func:`inner_sweeps_reference`, the plain PyTorch version that mirrors the
Pallas body line for line, for CPU tensors.  Nothing else selects between
them: a CUDA call that cannot build or launch the kernel raises.

Channel layout of the packed (18, R, N) constraint tensor (see
:func:`pack_row_fields`): normal(3) t1(3) t2(3) ra(3), then friction, bias,
normal_mass, tangent_mass1, tangent_mass2, valid.

:func:`inner_sweeps_blockmajor` runs the same kernel over the block-major
layout (nb, C, R, block) of ``scripts/micro_sweep.py::run_blockmajor``
(kernel K3): the kernel takes the block width as a stride, and the
(C, R, N) layout is the case block = N.  It is off the step path.
"""

from __future__ import annotations

import ctypes

import torch

from mgf_tpu_torch.ops import _build

_NCH = 18

# kernel launches made by inner_sweeps (LAUNCHES) and by
# inner_sweeps_blockmajor (BLOCKMAJOR_LAUNCHES) in this process (read and
# reset by callers that must show the main path went through the kernel)
LAUNCHES = 0
BLOCKMAJOR_LAUNCHES = 0


def pack_row_fields(rc) -> torch.Tensor:
    """Stack the RowConstraints channels the sweep reads into one
    (18, R, N) float32 tensor (built once per step; the kernel streams it
    once per sweep from device memory)."""
    return torch.stack([
        rc.normal.x, rc.normal.y, rc.normal.z,
        rc.t1.x, rc.t1.y, rc.t1.z,
        rc.t2.x, rc.t2.y, rc.t2.z,
        rc.ra.x, rc.ra.y, rc.ra.z,
        rc.friction, rc.bias, rc.normal_mass,
        rc.tangent_mass1, rc.tangent_mass2, rc.valid.to(torch.float32),
    ], dim=0)


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


def _check(S, fields, term, self_p, acc, lead=()):
    """Shapes (lead + (8, N)), (lead + (18, R, N)) ...; ``lead`` is (nb,)
    for the block-major layout."""
    n = S.shape[-1]
    L = len(lead)
    if tuple(S.shape) != tuple(lead) + (8, n):
        raise ValueError(f"S must be {tuple(lead) + (8, n)}, "
                         f"got {tuple(S.shape)}")
    if (fields.dim() != L + 3 or tuple(fields.shape[:L]) != tuple(lead)
            or fields.shape[L] != _NCH or fields.shape[L + 2] != n):
        raise ValueError(f"fields must be {tuple(lead) + (18, 'R', n)}, "
                         f"got {tuple(fields.shape)}")
    R = fields.shape[L + 1]
    for name, t, shape in (("term", term, lead + (3, R, n)),
                           ("self_p", self_p, lead + (2, n)),
                           ("acc", acc, lead + (3, R, n))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    for name, t in (("S", S), ("fields", fields), ("term", term),
                    ("self_p", self_p), ("acc", acc)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != S.device:
            raise ValueError(f"{name} is on {t.device}, S on {S.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _lib():
    lib = _build.load("solver_sweep")
    fn = lib.mgf_solver_sweep
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(S, fields, term, self_p, acc, inner_iters: int, block: int):
    if S.device.type != "cuda":
        raise ValueError(f"inner_sweeps runs on cuda or cpu, not {S.device}")
    fn = _lib()
    s_out = torch.empty_like(S)
    acc_out = torch.empty_like(acc)
    stream = torch.cuda.current_stream(S.device).cuda_stream
    n_cols = S.numel() // 8
    err = fn(S.data_ptr(), fields.data_ptr(), term.data_ptr(),
             self_p.data_ptr(), acc.data_ptr(), s_out.data_ptr(),
             acc_out.data_ptr(), n_cols, fields.shape[-2],
             int(inner_iters), int(block), stream)
    if err != 0:
        raise RuntimeError(f"solver_sweep kernel launch failed: cudaError {err}")
    return s_out, acc_out


def inner_sweeps(S, fields, term, self_p, acc, inner_iters: int):
    """Run ``inner_iters`` fused block-Jacobi inner sweeps.

    S        (8, N)  packed body state (rows vx vy vz ox oy oz _ _)
    fields   (18, R, N) from :func:`pack_row_fields`
    term     (3, R, N) frozen partner term (vb + ob x rb)
    self_p   (2, N)  [inv_mass, iso inverse inertia]
    acc      (3, R, N) accumulated impulses (n, t1, t2)

    Returns new (S', acc') tensors.  Any N works (the kernel masks the
    ragged edge).  CUDA tensors launch the kernel; CPU tensors run
    :func:`inner_sweeps_reference`.
    """
    global LAUNCHES
    _check(S, fields, term, self_p, acc)
    if S.device.type == "cpu":
        return inner_sweeps_reference(S, fields, term, self_p, acc,
                                      inner_iters)
    out = _launch(S, fields, term, self_p, acc, inner_iters, S.shape[1])
    LAUNCHES += 1
    return out


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
    b * block + j.  Returns (S', acc') in the same layout.  CUDA tensors
    launch the kernel with a block stride; CPU tensors run
    :func:`inner_sweeps_blockmajor_reference`."""
    global BLOCKMAJOR_LAUNCHES
    _check(S, fields, term, self_p, acc, lead=(S.shape[0],))
    if S.device.type == "cpu":
        return inner_sweeps_blockmajor_reference(S, fields, term, self_p,
                                                 acc, inner_iters)
    out = _launch(S, fields, term, self_p, acc, inner_iters, S.shape[-1])
    BLOCKMAJOR_LAUNCHES += 1
    return out

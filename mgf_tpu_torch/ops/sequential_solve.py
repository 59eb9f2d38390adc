"""Sequential Gauss-Seidel contact solve: the hand-written CUDA kernel K4.

Computes ``mgf_tpu/solver.py:192`` ``solve_sequential`` (a ``lax.scan``
over the contact points inside a ``lax.scan`` over the sweeps: no Pallas
twin, the device loop XLA makes of the scans).  Per sweep, each valid
point in order takes the friction impulse on both tangents from one
relative velocity, applies it, recomputes the relative velocity, and
applies the projected normal impulse; accumulators start at 0.

Inputs, all contiguous:

* ``pts`` (C, 20) float32, one row per point: ra, rb, normal, t1, t2 (3
  each), friction, bias, normal mass, tangent masses 1 and 2
  (:func:`pack_points`);
* ``body_a``, ``body_b`` (C,) int32 in [0, M); ``valid`` (C,) bool;
* ``bodies`` (M, 16) float32, one row per body: v, omega, inv_mass and the
  row-major 3x3 inverse inertia (:func:`pack_bodies`).

The result is the (M, 6) table of v and omega after the sweeps.  The kernel
(``csrc/sequential_solve.cu``) is one block: its threads compact the valid
points, then one thread runs the chain of point updates, the bodies and
accumulators in shared memory when they fit.  Its bound is that chain's
latency, not bytes or operations (see the source).

:func:`sequential_solve` launches the kernel for CUDA tensors and runs
:func:`sequential_solve_reference`, the plain PyTorch version, for CPU
tensors; nothing else selects between them.  The plain version loops in
Python over the valid points in order with each body's 3-vectors as rows of
(M, 3) tensors: exact, since an invalid point changes nothing, and about
60 small ops a point update, far too slow on the card at the demo's size.
"""

from __future__ import annotations

import ctypes

import torch

from mgf_tpu_torch.ops import _build

# kernel launches made by sequential_solve in this process (read and reset
# by callers that must show the main path went through the kernel)
LAUNCHES = 0

POINT_FLOATS = 20
BODY_FLOATS = 16
# dynamic shared memory one block may opt into on an H100 (227 KB), less
# the kernel's few static bytes
_SMEM_CAP = 227 * 1024 - 1024


def pack_points(con) -> torch.Tensor:
    """The (C, 20) point table of a ``solver.ContactConstraints``."""
    return torch.stack([*con.ra, *con.rb, *con.normal, *con.t1, *con.t2,
                        con.friction, con.bias, con.normal_mass,
                        con.tangent_mass1, con.tangent_mass2],
                       dim=1).contiguous()


def pack_bodies(v, omega, inv_mass, inv_moment) -> torch.Tensor:
    """The (M, 16) body table: v, omega (Vec3s), inv_mass, and the Mat3
    inverse inertia row-major."""
    return torch.stack([*v, *omega, inv_mass, *inv_moment],
                       dim=1).contiguous()


def sequential_solve_reference(pts, body_a, body_b, valid, bodies, iters,
                               mgf):
    """The plain PyTorch version: solve_sequential's scan body, point by
    point in Python, in the JAX package's op order."""
    V = bodies[:, 0:3].clone()
    W = bodies[:, 3:6].clone()
    inv_mass = bodies[:, 6]
    inertia = bodies[:, 7:16].reshape(-1, 3, 3)
    idx = torch.nonzero(valid).flatten().tolist()
    a_l, b_l = body_a.tolist(), body_b.tolist()
    cross = torch.linalg.cross
    mat_vec = lambda m, x: (m * x).sum(dim=1)
    # per valid point: its bodies and its fields as views, made once
    rows = [(a_l[i], b_l[i], *(pts[i, k:k + 3] for k in range(0, 15, 3)),
             *pts[i, 15:20]) for i in idx]
    zero = torch.zeros((), dtype=pts.dtype, device=pts.device)
    acc = [[zero, zero, zero] for _ in idx]
    for _ in range(iters):
        for (a, b, ra, rb, n, t1, t2, friction, bias, nm, tm1, tm2), ac in \
                zip(rows, acc):
            acc_n, acc_t1, acc_t2 = ac
            va, wa, vb, wb = V[a], W[a], V[b], W[b]
            ima, imb, Ia, Ib = inv_mass[a], inv_mass[b], inertia[a], inertia[b]
            dv = vb + cross(wb, rb) - va - cross(wa, ra)
            lam1 = -(dv * t1).sum() * tm1
            lam2 = -(dv * t2).sum() * tm2
            if mgf:
                f1, f2 = lam1, lam2
                new1, new2 = acc_t1 + lam1, acc_t2 + lam2
            else:
                max_l = friction * acc_n
                new1 = torch.minimum(torch.maximum(acc_t1 + lam1, -max_l),
                                     max_l)
                new2 = torch.minimum(torch.maximum(acc_t2 + lam2, -max_l),
                                     max_l)
                f1, f2 = new1 - acc_t1, new2 - acc_t2
            imp = t1 * f1 + t2 * f2
            va = va - imp * ima
            wa = wa - mat_vec(Ia, cross(ra, imp))
            vb = vb + imp * imb
            wb = wb + mat_vec(Ib, cross(rb, imp))
            dv = vb + cross(wb, rb) - va - cross(wa, ra)
            lam = nm * (-(dv * n).sum() + bias)
            new_n = torch.clamp(acc_n + lam, min=0.0)
            imp = n * (new_n - acc_n)
            V[a] = va - imp * ima
            W[a] = wa - mat_vec(Ia, cross(ra, imp))
            V[b] = vb + imp * imb
            W[b] = wb + mat_vec(Ib, cross(rb, imp))
            ac[:] = new_n, new1, new2
    return torch.cat([V, W], dim=1)


def _check(pts, body_a, body_b, valid, bodies):
    C = pts.shape[0]
    if pts.dim() != 2 or pts.shape[1] != POINT_FLOATS:
        raise ValueError(f"pts must be (C, {POINT_FLOATS}), got "
                         f"{tuple(pts.shape)}")
    if bodies.dim() != 2 or bodies.shape[1] != BODY_FLOATS:
        raise ValueError(f"bodies must be (M, {BODY_FLOATS}), got "
                         f"{tuple(bodies.shape)}")
    for name, t, dt in (("pts", pts, torch.float32),
                        ("body_a", body_a, torch.int32),
                        ("body_b", body_b, torch.int32),
                        ("valid", valid, torch.bool),
                        ("bodies", bodies, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != pts.device:
            raise ValueError(f"{name} is on {t.device}, pts on {pts.device}")
        if name not in ("pts", "bodies") and tuple(t.shape) != (C,):
            raise ValueError(f"{name} must be ({C},), got {tuple(t.shape)}")


def _lib():
    fn = _build.load("sequential_solve").mgf_sequential_solve
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def sequential_solve(pts, body_a, body_b, valid, bodies, iters: int,
                     mgf: bool):
    """v and omega (an (M, 6) table) after ``iters`` Gauss-Seidel sweeps
    over the valid points in order, friction textbook-clamped or, with
    ``mgf``, the reference's raw lambda.  CUDA tensors launch kernel K4;
    CPU tensors run :func:`sequential_solve_reference`."""
    global LAUNCHES
    _check(pts, body_a, body_b, valid, bodies)
    if pts.device.type == "cpu":
        return sequential_solve_reference(pts, body_a, body_b, valid, bodies,
                                          iters, mgf)
    if pts.device.type != "cuda":
        raise ValueError(f"sequential_solve runs on cuda or cpu, not "
                         f"{pts.device}")
    fn = _lib()
    C, M = pts.shape[0], bodies.shape[0]
    body_bytes = 4 * BODY_FLOATS * M
    in_smem = body_bytes <= _SMEM_CAP
    smem = min(_SMEM_CAP, (body_bytes if in_smem else 0) + 12 * C)
    acc_room = smem - (body_bytes if in_smem else 0)
    out = torch.empty_like(bodies)
    order = torch.empty((max(C, 1),), dtype=torch.int32, device=pts.device)
    acc = (None if 12 * C <= acc_room else
           torch.empty((3 * C,), dtype=torch.float32, device=pts.device))
    stream = torch.cuda.current_stream(pts.device).cuda_stream
    err = fn(pts.data_ptr(), body_a.data_ptr(), body_b.data_ptr(),
             valid.data_ptr(), bodies.data_ptr(), out.data_ptr(),
             order.data_ptr(), None if acc is None else acc.data_ptr(),
             C, M, int(iters), int(bool(mgf)), int(in_smem), smem, stream)
    if err != 0:
        raise RuntimeError(f"sequential_solve kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES += 1
    return out[:, :6]


def capture_inputs(run):
    """Call ``run()`` (e.g. a world step on the sequential solver) and
    return (the inputs of the last :func:`sequential_solve` call it made,
    run's result).  The inputs are a dict of ``pts``, ``a``, ``b``,
    ``valid``, ``bodies`` (the tensors the call got), ``iters`` and
    ``mgf``; the call itself runs as usual."""
    global sequential_solve
    solve, rec = sequential_solve, {}

    def record(pts, body_a, body_b, valid, bodies, iters, mgf):
        rec.update(pts=pts, a=body_a, b=body_b, valid=valid, bodies=bodies,
                   iters=iters, mgf=mgf)
        return solve(pts, body_a, body_b, valid, bodies, iters, mgf)

    sequential_solve = record
    try:
        out = run()
    finally:
        sequential_solve = solve
    return rec, out

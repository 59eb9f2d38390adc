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

The result is the (M, 6) table of v and omega after the sweeps.

Two updates that share no dynamic body commute exactly, and a static row
(:func:`static_rows`: the terrain's) never changes, so the sweeps can run
level by level over the points' body-dependency graph
(:func:`sequential_schedule`) with the serial result bit for bit.  The
kernel (``csrc/sequential_solve.cu``) is one block: it compacts the valid
points, builds the levels in rounds, stages the bodies and rows in shared
memory, then runs each level's updates in parallel with a barrier between
levels.  Its bound is the graph's depth times one update's chain of
dependent operations, not bytes or operations (see the source).

:func:`sequential_solve` launches the kernel for CUDA tensors and runs
:func:`sequential_solve_levels_reference`, the level plain version, for CPU
tensors; nothing else selects between them.
:func:`sequential_solve_reference`, the serial plain version (one valid
point at a time, in order), is the oracle both are held to.  The plain
versions share one batched update whose every product and sum is an op of
its own, in the kernel's order.
"""

from __future__ import annotations

import ctypes

import torch

from mgf_tpu_torch.ops import _build, launches

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
    """The serial plain version, the oracle: solve_sequential's scan body,
    one valid point at a time in list order, every body row written."""
    idx = torch.nonzero(valid).flatten()
    return _solve(pts, body_a, body_b, bodies, iters, mgf,
                  [idx[k:k + 1] for k in range(idx.numel())],
                  skip_static=False)


def static_rows(bodies):
    """(M,) bool: the body rows whose inverse mass and nine inverse-inertia
    entries are all 0.  An update adds 0 * impulse to such a row, so it
    never changes (for finite impulses, and up to the sign of a zero
    velocity: +0 stays +0), and no update has to wait for it."""
    return (bodies[:, 6:16] == 0).all(dim=1)


def sequential_schedule(body_a, body_b, valid, bodies, sweeps=1):
    """(C,) int64 on the inputs' device: the level of each valid point (0
    where invalid).  In list order, a point's level is 1 + the larger of
    the last levels given to its dynamic bodies (0 for a static body, see
    :func:`static_rows`), and becomes the last level of each of them.  So
    each dynamic body's points have strictly increasing levels in list
    order, two points of one level share no dynamic body, and solving the
    levels in turn repeats the serial order's arithmetic on every value.
    ``sweeps`` > 1 runs the rule on over that many sweeps of the list
    without starting the levels again (a pipelined schedule) and returns
    the last sweep's levels: their maximum is the pipelined depth."""
    static = static_rows(bodies).tolist()
    last = [0] * len(static)
    level = [0] * valid.numel()
    idx = torch.nonzero(valid).flatten().tolist()
    a_l, b_l = body_a.tolist(), body_b.tolist()
    for _ in range(sweeps):
        for i in idx:
            a, b = a_l[i], b_l[i]
            lv = 1 + max(last[a], last[b])
            level[i] = lv
            for x in (a, b):
                if not static[x]:
                    last[x] = lv
    return torch.tensor(level, dtype=torch.int64, device=body_a.device)


def _dot(u, v):
    return (u[:, 0] * v[:, 0] + u[:, 1] * v[:, 1]) + u[:, 2] * v[:, 2]


def _cross(u, v):
    return torch.stack([u[:, 1] * v[:, 2] - u[:, 2] * v[:, 1],
                        u[:, 2] * v[:, 0] - u[:, 0] * v[:, 2],
                        u[:, 0] * v[:, 1] - u[:, 1] * v[:, 0]], dim=1)


def _mat_vec(m, x):
    """(n, 3, 3) row-major matrices times (n, 3) vectors, by column."""
    return ((m[:, :, 0] * x[:, 0:1] + m[:, :, 1] * x[:, 1:2])
            + m[:, :, 2] * x[:, 2:3])


def _solve(pts, body_a, body_b, bodies, iters, mgf, groups, skip_static):
    """``iters`` sweeps over ``groups`` (index tensors of points, in turn;
    the points of one group share no dynamic body), each group's updates
    as one batch of tensor ops.  Every product, sum and difference is an
    op of its own, in the kernel's order: three-term sums as (x0*y0 +
    x1*y1) + x2*y2, the Mat3 product by column and the cross product
    written out (torch.linalg.cross on the CPU may contract a1*b2 - a2*b1
    into a fused multiply-add, which the kernel never does), so each value
    rounds once, as in the kernel, on any platform.  ``skip_static``
    writes no static row (:func:`static_rows`)."""
    V = bodies[:, 0:3].clone()
    W = bodies[:, 3:6].clone()
    inv_mass = bodies[:, 6:7]
    inertia = bodies[:, 7:16].reshape(-1, 3, 3)
    dynamic = ~static_rows(bodies)
    qs = []
    for g in groups:
        a, b = body_a[g].long(), body_b[g].long()
        p = pts[g]
        put_a, put_b = ((a[dynamic[a]], b[dynamic[b]]) if skip_static
                        else (a, b))
        qs.append(dict(
            a=a, b=b, put_a=put_a, put_b=put_b, da=dynamic[a],
            db=dynamic[b], ra=p[:, 0:3], rb=p[:, 3:6], n=p[:, 6:9],
            t1=p[:, 9:12], t2=p[:, 12:15], friction=p[:, 15], bias=p[:, 16],
            nm=p[:, 17], tm1=p[:, 18], tm2=p[:, 19], ima=inv_mass[a],
            imb=inv_mass[b], Ia=inertia[a], Ib=inertia[b],
            acc=[torch.zeros_like(p[:, 15]) for _ in range(3)]))
    for _ in range(iters):
        for q in qs:
            a, b, ra, rb, ima, imb, Ia, Ib = (q[k] for k in (
                "a", "b", "ra", "rb", "ima", "imb", "Ia", "Ib"))
            acc_n, acc_t1, acc_t2 = q["acc"]
            va, wa, vb, wb = V[a], W[a], V[b], W[b]
            # friction on both tangents from one dv (solver.rs:220-232)
            dv = vb + _cross(wb, rb) - va - _cross(wa, ra)
            lam1 = -_dot(dv, q["t1"]) * q["tm1"]
            lam2 = -_dot(dv, q["t2"]) * q["tm2"]
            if mgf:
                f1, f2 = lam1, lam2
                new1, new2 = acc_t1 + lam1, acc_t2 + lam2
            else:
                max_l = q["friction"] * acc_n
                new1 = torch.minimum(torch.maximum(acc_t1 + lam1, -max_l),
                                     max_l)
                new2 = torch.minimum(torch.maximum(acc_t2 + lam2, -max_l),
                                     max_l)
                f1, f2 = new1 - acc_t1, new2 - acc_t2
            imp = q["t1"] * f1[:, None] + q["t2"] * f2[:, None]
            va = va - imp * ima
            wa = wa - _mat_vec(Ia, _cross(ra, imp))
            vb = vb + imp * imb
            wb = wb + _mat_vec(Ib, _cross(rb, imp))
            # projected normal impulse (solver.rs:236-240)
            dv = vb + _cross(wb, rb) - va - _cross(wa, ra)
            lam = q["nm"] * (-_dot(dv, q["n"]) + q["bias"])
            new_n = torch.clamp(acc_n + lam, min=0.0)
            imp = q["n"] * (new_n - acc_n)[:, None]
            va = va - imp * ima
            wa = wa - _mat_vec(Ia, _cross(ra, imp))
            vb = vb + imp * imb
            wb = wb + _mat_vec(Ib, _cross(rb, imp))
            if skip_static:
                da, db = q["da"], q["db"]
                va, wa, vb, wb = va[da], wa[da], vb[db], wb[db]
            # body a first, then b (a point on one body twice: b's wins)
            V[q["put_a"]], W[q["put_a"]] = va, wa
            V[q["put_b"]], W[q["put_b"]] = vb, wb
            q["acc"] = [new_n, new1, new2]
    return torch.cat([V, W], dim=1)


def sequential_solve_levels_reference(pts, body_a, body_b, valid, bodies,
                                      iters, mgf):
    """The level plain version: each sweep solves the levels of
    :func:`sequential_schedule` in turn, each level as one batch, and
    writes no static row.  Its arithmetic is the serial version's, op for
    op, so the result equals :func:`sequential_solve_reference` bit for
    bit (a static row too, unless it starts at -0)."""
    level = sequential_schedule(body_a, body_b, valid, bodies)
    idx = torch.nonzero(valid).flatten()
    idx = idx[torch.argsort(level[idx], stable=True)]
    sizes = torch.bincount(level[idx], minlength=1).tolist()[1:]
    return _solve(pts, body_a, body_b, bodies, iters, mgf,
                  torch.split(idx, sizes), skip_static=True)


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
    _check(pts, body_a, body_b, valid, bodies)
    if pts.device.type == "cpu":
        return sequential_solve_levels_reference(pts, body_a, body_b, valid,
                                                 bodies, iters, mgf)
    if pts.device.type != "cuda":
        raise ValueError(f"sequential_solve runs on cuda or cpu, not "
                         f"{pts.device}")
    fn = _lib()
    C, M = pts.shape[0], bodies.shape[0]
    out = torch.empty_like(bodies)
    iscratch = torch.empty((10 * C + 2 * M + 1,), dtype=torch.int32,
                           device=pts.device)
    fscratch = torch.empty((max(23 * C, 1),), dtype=torch.float32,
                           device=pts.device)
    stream = torch.cuda.current_stream(pts.device).cuda_stream
    err = fn(pts.data_ptr(), body_a.data_ptr(), body_b.data_ptr(),
             valid.data_ptr(), bodies.data_ptr(), out.data_ptr(),
             iscratch.data_ptr(), fscratch.data_ptr(), C, M, int(iters),
             int(bool(mgf)), 1, _SMEM_CAP, stream)
    if err != 0:
        raise RuntimeError(f"sequential_solve kernel launch failed: "
                           f"cudaError {err}")
    launches.count(__name__, "LAUNCHES")
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

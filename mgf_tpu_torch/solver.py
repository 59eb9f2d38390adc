"""Row-structured contact solver: the isotropic (sphere) path and the
general Mat3-inertia path of capsules.

Counterpart of the row solver of ``mgf_tpu.solver`` (reference: solver.rs
impulse math, warm-started sequential impulses with Baumgarte
stabilization, restitution threshold and two-axis friction).  Every body
owns a row of R constraint slots (its broadphase partners plus terrain
triangles); each pair appears twice, once per body, mirrored; a solver
iteration is one gather of the packed (8, N) body state by the (R, N)
partner matrix, elementwise impulse math and a sum over the R axis.

``solve_rows`` runs textbook friction, single- and two-phase, with scalar
(isotropic) or Mat3 inverse inertia, warm starting, ``partner_term0``,
``n_gather_rows``, block solves over a column range (``col_offset``,
``state0``, ``return_state``) and the fused gather + inner-sweep kernel
(``pallas_inner``, kept under the JAX package's name: here it selects the
CUDA kernel of ``ops/solver_sweep.py``; scalar inertia, no column offset).
The constraint builds: :func:`build_row_constraints` (Mat3 inertia, three
8-wide partner gathers), :func:`build_row_constraints_iso` (one 16-wide
partner gather, the generic sphere branch) and
:func:`build_row_constraints_iso_fused` (gather-free, the flagship).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mgf_tpu_torch.manifold import Manifold
from mgf_tpu_torch.math3d import (
    Mat3, Vec3, cross, dot, magnitude2, mat_vec, safe_div, tree_map,
)
from mgf_tpu_torch.ops import solver_sweep as _ss

# DefaultContactConstraintParams (solver.rs:276-279)
PENETRATION_SLOP = 0.05
BAUMGARTE = 0.2


def contact_bias(pen, rel_v, restitution, dt, bias_max: float = -1.0):
    """Baumgarte + restitution bias velocity (solver.rs:145-153).
    ``bias_max`` >= 0 clamps the position-correction term (a documented
    extension of the JAX package, off by default)."""
    b = -BAUMGARTE / dt * torch.where(pen > 0.0, 0.0, pen + PENETRATION_SLOP)
    if bias_max >= 0.0:
        b = torch.clamp(b, max=bias_max)
    return b + torch.where(rel_v < -1.0, -restitution * rel_v, 0.0)


class BodyView(NamedTuple):
    """Per-body quantities the solver reads (ConstrainedSet get,
    physics.rs:272-304).  ``x`` is the end-of-sweep position."""
    x: Vec3
    v: Vec3
    omega: Vec3
    restitution: torch.Tensor
    friction: torch.Tensor
    inv_mass: torch.Tensor
    inv_moment: Mat3


class RowConstraints(NamedTuple):
    """Per-body rows of contact-point slots; all tensors (R, N)."""
    partner: torch.Tensor   # (R, N) int32 partner body (n for terrain)
    ra: Vec3                # contact point local to the row body
    rb: Vec3                # contact point local to the partner
    normal: Vec3
    t1: Vec3
    t2: Vec3
    friction: torch.Tensor
    bias: torch.Tensor
    normal_mass: torch.Tensor
    tangent_mass1: torch.Tensor
    tangent_mass2: torch.Tensor
    valid: torch.Tensor     # (R, N) bool


class PartnerFields(NamedTuple):
    """Pre-gathered partner-side quantities for the fused iso constraint
    build (one wide row gather at narrowphase time serves both the contact
    test and the constraint precompute).  All tensors (K, N)."""
    x_end: Vec3            # partner position at end of sweep (x + delta)
    v: Vec3
    omega: Vec3
    restitution: torch.Tensor
    friction: torch.Tensor
    inv_mass: torch.Tensor
    count: torch.Tensor    # mass-splitting contact count (clamped >= 1)
    iso: torch.Tensor      # isotropic world inverse inertia scalar


def pack_solver_bodies(bodies: BodyView, counts=None):
    """The per-body quantities the constraint precompute reads as three
    (M, 8) tables, so the (R, N)-indexed reads are 3 wide gathers:

    A: x.xyz  v.xyz  restitution friction
    B: omega.xyz  inv_mass  count  _ _ _
    C: inverse inertia (symmetric): Ixx Ixy Ixz Iyy Iyz Izz _ _
    """
    z = torch.zeros_like(bodies.inv_mass)
    cnt = counts if counts is not None else torch.ones_like(bodies.inv_mass)
    A = torch.stack([bodies.x.x, bodies.x.y, bodies.x.z,
                     bodies.v.x, bodies.v.y, bodies.v.z,
                     bodies.restitution, bodies.friction], dim=-1)
    B = torch.stack([bodies.omega.x, bodies.omega.y, bodies.omega.z,
                     bodies.inv_mass, cnt, z, z, z], dim=-1)
    I = bodies.inv_moment
    C = torch.stack([I.xx, I.xy, I.xz, I.yy, I.yz, I.zz, z, z], dim=-1)
    return A, B, C


def _unpack_solver_rows(A, B, C, idx):
    idx = idx.long()
    a = A[idx]
    b = B[idx]
    c = C[idx]
    x = Vec3(a[..., 0], a[..., 1], a[..., 2])
    v = Vec3(a[..., 3], a[..., 4], a[..., 5])
    restitution = a[..., 6]
    friction = a[..., 7]
    omega = Vec3(b[..., 0], b[..., 1], b[..., 2])
    inv_mass = b[..., 3]
    count = b[..., 4]
    I = Mat3(c[..., 0], c[..., 1], c[..., 2],
             c[..., 1], c[..., 3], c[..., 4],
             c[..., 2], c[..., 4], c[..., 5])
    return x, v, omega, restitution, friction, inv_mass, count, I


def build_row_constraints(bodies: BodyView, partner, manifold: Manifold,
                          dt, counts=None, col_offset: int = 0,
                          bias_max: float = -1.0) -> RowConstraints:
    """Per-slot state for the row solver with Mat3 inertia.

    ``partner`` is (R, N) int32 into the M rows of ``bodies`` (the static
    terrain row last); ``manifold`` fields are shaped (R, N).  ``counts``
    (M,) enables mass splitting.  The N columns are bodies ``col_offset ..
    col_offset + N``; the self side is read with slices, not gathers."""
    n = partner.shape[1]
    lo, hi = col_offset, col_offset + n
    A, B, C = pack_solver_bodies(bodies, counts)

    sl = lambda t: tree_map(lambda g: g[lo:hi][None, :], t)
    xa = sl(bodies.x)
    va, oa = sl(bodies.v), sl(bodies.omega)
    ima = bodies.inv_mass[lo:hi][None, :]
    Ia = sl(bodies.inv_moment)
    ra_ = bodies.restitution[lo:hi][None, :]
    fa = bodies.friction[lo:hi][None, :]

    (xb, vb, ob, rb_, fb, imb, sb, Ib) = _unpack_solver_rows(A, B, C,
                                                             partner)

    restitution = torch.maximum(ra_, rb_)
    friction = torch.sqrt(fa * fb)

    if counts is not None:
        sa = counts[lo:hi][None, :]
        ima = ima * sa
        imb = imb * sb
        Ia = Ia * sa
        Ib = Ib * sb

    ra = manifold.local_a
    rb = manifold.local_b
    nrm = manifold.normal
    t1, t2 = manifold.t1, manifold.t2

    pen = dot((rb + xb) - (ra + xa), nrm)
    dv = vb + cross(ob, rb) - va - cross(oa, ra)
    rel_v = dot(dv, nrm)
    bias = contact_bias(pen, rel_v, restitution, dt, bias_max)

    def eff_mass(axis):
        ra_c = cross(ra, axis)
        rb_c = cross(rb, axis)
        return safe_div(
            1.0, ima + dot(ra_c, mat_vec(Ia, ra_c))
            + imb + dot(rb_c, mat_vec(Ib, rb_c)))

    return RowConstraints(
        partner=partner, ra=ra, rb=rb, normal=nrm, t1=t1, t2=t2,
        friction=friction, bias=bias, normal_mass=eff_mass(nrm),
        tangent_mass1=eff_mass(t1), tangent_mass2=eff_mass(t2),
        valid=manifold.valid)


def pack_solver_bodies_iso(bodies: BodyView, counts, iso_inv_moment):
    """One (M, 16) table for the isotropic-inertia constraint precompute,
    so the partner side is a single 16-wide row gather:

    x.xyz v.xyz omega.xyz restitution friction inv_mass count i_iso _ _
    """
    z = torch.zeros_like(bodies.inv_mass)
    cnt = counts if counts is not None else torch.ones_like(bodies.inv_mass)
    return torch.stack([
        bodies.x.x, bodies.x.y, bodies.x.z,
        bodies.v.x, bodies.v.y, bodies.v.z,
        bodies.omega.x, bodies.omega.y, bodies.omega.z,
        bodies.restitution, bodies.friction, bodies.inv_mass, cnt,
        iso_inv_moment, z, z], dim=-1)


def build_row_constraints_iso(bodies: BodyView, partner, manifold: Manifold,
                              dt, counts=None, bias_max: float = -1.0):
    """Scalar-inertia row constraints (spheres).  ``bodies`` covers
    M = N + 1 rows (the static terrain row last) and ``partner`` (R, N)
    indexes them.  Returns (rc, partner_term0): the second is the first
    sweep's partner term vb + ob x rb, which rides this gather for free."""
    n = partner.shape[1]
    iso = bodies.inv_moment.xx          # (M,) — diag isotropic by contract
    tbl = pack_solver_bodies_iso(bodies, counts, iso)

    sl = lambda v: Vec3(*(c[:n][None, :] for c in v))
    xa = sl(bodies.x)
    va, oa = sl(bodies.v), sl(bodies.omega)
    ima = bodies.inv_mass[:n][None, :]
    ia = iso[:n][None, :]
    ra_ = bodies.restitution[:n][None, :]
    fa = bodies.friction[:n][None, :]

    g = tbl[partner.long()]              # (R, N, 16): ONE gather
    xb = Vec3(g[..., 0], g[..., 1], g[..., 2])
    vb = Vec3(g[..., 3], g[..., 4], g[..., 5])
    ob = Vec3(g[..., 6], g[..., 7], g[..., 8])
    rb_ = g[..., 9]
    fb = g[..., 10]
    imb = g[..., 11]
    sb = g[..., 12]
    ib = g[..., 13]
    partner_term0 = vb + cross(ob, manifold.local_b)

    restitution = torch.maximum(ra_, rb_)
    friction = torch.sqrt(fa * fb)
    if counts is not None:
        sa = counts[:n][None, :]
        ima = ima * sa
        imb = imb * sb
        ia = ia * sa
        ib = ib * sb

    ra = manifold.local_a
    rb = manifold.local_b
    nrm = manifold.normal
    t1, t2 = manifold.t1, manifold.t2

    pen = dot((rb + xb) - (ra + xa), nrm)
    dv = vb + cross(ob, rb) - va - cross(oa, ra)
    rel_v = dot(dv, nrm)
    bias = contact_bias(pen, rel_v, restitution, dt, bias_max)

    def eff_mass(axis):
        return safe_div(
            1.0, ima + ia * magnitude2(cross(ra, axis))
            + imb + ib * magnitude2(cross(rb, axis)))

    rc = RowConstraints(
        partner=partner, ra=ra, rb=rb, normal=nrm, t1=t1, t2=t2,
        friction=friction, bias=bias, normal_mass=eff_mass(nrm),
        tangent_mass1=eff_mass(t1), tangent_mass2=eff_mass(t2),
        valid=manifold.valid)
    return rc, partner_term0


def build_row_constraints_iso_fused(bodies: BodyView, counts,
                                    pf: PartnerFields, partner,
                                    manifold: Manifold, dt,
                                    static_x: Vec3,
                                    n_pair_rows: int,
                                    bias_max: float = -1.0) -> RowConstraints:
    """Gather-free iso constraint precompute: rows ``[:n_pair_rows]`` read
    ``pf``; the remaining rows have the static terrain body as partner
    (zero inverse mass/inertia/velocity, position ``static_x``, zero
    friction and restitution — ``RigidBodyRef::Static``, physics.rs:289-302).
    ``counts`` is the (N,) mass-splitting count, the PREVIOUS frame's on the
    fused path (a documented approximation of the JAX package)."""
    n = partner.shape[1]
    T = partner.shape[0] - n_pair_rows
    iso = bodies.inv_moment.xx

    zt = torch.zeros((T, n), dtype=torch.float32, device=partner.device)
    cat = lambda p, t_: torch.cat([p, t_], dim=0)
    catv = lambda p, t_: Vec3(cat(p.x, t_.x), cat(p.y, t_.y), cat(p.z, t_.z))
    zvt = Vec3(zt, zt, zt)

    xb = catv(pf.x_end, Vec3(zt + static_x.x, zt + static_x.y,
                             zt + static_x.z))
    vb = catv(pf.v, zvt)
    ob = catv(pf.omega, zvt)
    rb_ = cat(pf.restitution, zt)
    fb = cat(pf.friction, zt)
    imb = cat(pf.inv_mass * pf.count, zt)   # pre-split by partner count
    ib = cat(pf.iso * pf.count, zt)

    # self side: broadcasts, no gather
    sl = lambda g: g[None, :]
    xa = Vec3(*(sl(c) for c in bodies.x))
    va = Vec3(*(sl(c) for c in bodies.v))
    oa = Vec3(*(sl(c) for c in bodies.omega))
    ima = (bodies.inv_mass * counts)[None, :]
    ia = (iso * counts)[None, :]
    ra_ = bodies.restitution[None, :]
    fa = bodies.friction[None, :]

    restitution = torch.maximum(ra_, rb_)
    friction = torch.sqrt(fa * fb)

    ra = manifold.local_a
    rb = manifold.local_b
    nrm = manifold.normal
    t1, t2 = manifold.t1, manifold.t2

    pen = dot((rb + xb) - (ra + xa), nrm)
    dv = vb + cross(ob, rb) - va - cross(oa, ra)
    rel_v = dot(dv, nrm)
    bias = contact_bias(pen, rel_v, restitution, dt, bias_max)

    def eff_mass(axis):
        return safe_div(
            1.0, ima + ia * magnitude2(cross(ra, axis))
            + imb + ib * magnitude2(cross(rb, axis)))

    return RowConstraints(
        partner=partner, ra=ra, rb=rb, normal=nrm, t1=t1, t2=t2,
        friction=friction, bias=bias, normal_mass=eff_mass(nrm),
        tangent_mass1=eff_mass(t1), tangent_mass2=eff_mass(t2),
        valid=manifold.valid)


def pack_body_state(v: Vec3, omega: Vec3):
    """(8, M) packed dynamic state: rows vx vy vz ox oy oz pad pad."""
    z = torch.zeros_like(v.x)
    return torch.stack([v.x, v.y, v.z, omega.x, omega.y, omega.z, z, z],
                       dim=0)


def unpack_body_state(S):
    return (Vec3(S[0], S[1], S[2]), Vec3(S[3], S[4], S[5]))


def _friction_impulses(rc, dv: Vec3, acc_t1, acc_t2, acc_n):
    """Both tangent-axis lambdas from a single dv with the textbook clamped
    accumulator (solver.rs:220-232).  Returns (applied1, applied2,
    new_acc1, new_acc2)."""
    lam1 = -dot(dv, rc.t1) * rc.tangent_mass1
    lam2 = -dot(dv, rc.t2) * rc.tangent_mass2
    max_l = rc.friction * acc_n
    new1 = torch.minimum(torch.maximum(acc_t1 + lam1, -max_l), max_l)
    new2 = torch.minimum(torch.maximum(acc_t2 + lam2, -max_l), max_l)
    return new1 - acc_t1, new2 - acc_t2, new1, new2


def _normal_impulse(rc, dv: Vec3, acc_n):
    """Projected normal impulse (solver.rs:236-240)."""
    vn = dot(dv, rc.normal)
    lam = rc.normal_mass * (-vn + rc.bias)
    new_acc = torch.clamp(acc_n + lam, min=0.0)
    return new_acc - acc_n, new_acc


def solve_rows(rc: RowConstraints, v: Vec3, omega: Vec3, inv_mass,
               inv_moment, iters: int, friction_mode: str = "textbook",
               two_phase: bool = True, inner_iters: int = 1, warm=None,
               return_acc: bool = False, partner_term0: Vec3 = None,
               n_gather_rows: int = None, pallas_inner: bool = False,
               col_offset: int = 0, state0=None, return_state: bool = False):
    """Scatter-free row sweeps.  ``v``/``omega``/``inv_mass`` cover M >= N
    rows (N = ``rc.partner.shape[1]``); only bodies ``[col_offset,
    col_offset + N)`` are updated, every other row (statics included) is
    returned unchanged.  A block's partner gathers read the GLOBAL state,
    so block solves chained through ``state0`` compose as a two-colour
    Gauss-Seidel.

    ``inv_moment`` is the (M,) isotropic scalar inverse inertia, or a Mat3
    of (M,) components.  ``state0``/``return_state`` pass and return the
    packed (8, M) state, so chained block solves skip a pack and unpack.
    ``inner_iters`` > 1 runs block-Jacobi inner sweeps with partner
    velocities frozen between gathers (``iters`` gathers, ``iters *
    inner_iters`` sweeps).  ``warm`` is an optional (acc_n, acc_t1, acc_t2)
    triple of (R, N) accumulated impulses matched from the previous frame:
    applied up front and used as the accumulator seed.  ``partner_term0``
    is the first outer iteration's frozen partner term (from the constraint
    precompute's gather); later iterations gather again.  ``n_gather_rows``:
    rows past this index have a STATIC partner, so their partner term is
    zero and the per-sweep state gather fetches only the leading rows.
    ``pallas_inner`` runs each outer iteration, partner gather and inner
    sweeps, as one call of
    :func:`mgf_tpu_torch.ops.solver_sweep.inner_sweeps_gather` (of
    ``inner_sweeps`` where ``partner_term0`` gives the term): the CUDA
    kernel on a card, R <= 32 rows, single-phase textbook friction, scalar
    inertia and no column offset only.

    Returns (v, omega) for all M rows, or the packed state with
    ``return_state``; plus the (R, N) accumulator triple with
    ``return_acc``.
    """
    if friction_mode != "textbook":
        raise NotImplementedError(
            "solve_rows with friction_mode='mgf' arrives with the "
            "reference-solver slice (ROADMAP slice 10)")
    n = rc.partner.shape[1]
    lo, hi = col_offset, col_offset + n
    S = pack_body_state(v, omega) if state0 is None else state0
    M = S.shape[1]
    ima = inv_mass[lo:hi]
    mat3 = isinstance(inv_moment, Mat3)
    if mat3:
        Ia = tree_map(lambda g: g[lo:hi], inv_moment)
        apply_I = lambda vec: mat_vec(Ia, vec)
    else:
        ia_s = inv_moment[lo:hi]
        apply_I = lambda vec: vec * ia_s
    R_tot = rc.partner.shape[0]
    K = R_tot if n_gather_rows is None else min(n_gather_rows, R_tot)
    rb_k = Vec3(*(c[:K] for c in rc.rb))

    def self_term(S):
        va = Vec3(S[0, lo:hi][None], S[1, lo:hi][None], S[2, lo:hi][None])
        oa = Vec3(S[3, lo:hi][None], S[4, lo:hi][None], S[5, lo:hi][None])
        return va + cross(oa, rc.ra)

    def apply_self(S, imp: Vec3):
        """Row bodies receive -impulse (self is side a).  The update is
        out of place: the columns before, of and after the block."""
        imp = imp * rc.valid
        lin = Vec3(-imp.x.sum(0), -imp.y.sum(0), -imp.z.sum(0)) * ima
        ang_pt = -cross(rc.ra, imp)
        ang = apply_I(Vec3(ang_pt.x.sum(0), ang_pt.y.sum(0),
                           ang_pt.z.sum(0)))
        upd = torch.stack([lin.x, lin.y, lin.z, ang.x, ang.y, ang.z], dim=0)
        cols = [S[:6, lo:hi] + upd]
        if lo:
            cols.insert(0, S[:6, :lo])
        if hi < M:
            cols.append(S[:6, hi:])
        top = torch.cat(cols, dim=1) if len(cols) > 1 else cols[0]
        return torch.cat([top, S[6:]], dim=0)

    zero = torch.zeros(rc.valid.shape, dtype=torch.float32,
                       device=S.device)
    if warm is None:
        acc0 = (zero, zero, zero)
    else:
        wn, wt1, wt2 = [w * rc.valid for w in warm]
        S = apply_self(S, rc.t1 * wt1 + rc.t2 * wt2 + rc.normal * wn)
        acc0 = (wn, wt1, wt2)

    if pallas_inner:
        if two_phase or mat3 or col_offset:
            raise ValueError("pallas_inner requires the single-phase "
                             "textbook-friction iso (scalar inertia) path "
                             "without a column offset")
        # one kernel launch per outer iteration: the partner gather runs
        # inside it (gather mode), except where partner_term0 is given
        fields = _ss.pack_row_fields(rc)
        self_p = torch.stack([ima, ia_s])
        acc = torch.stack(acc0)
        rb = torch.stack(tuple(rb_k))
        partner = rc.partner.to(torch.int32).contiguous()
        for k in range(iters):
            if k == 0 and partner_term0 is not None:
                t = partner_term0
                Sn, acc = _ss.inner_sweeps(
                    S[:, :n].contiguous(), fields,
                    torch.stack([t.x, t.y, t.z]), self_p, acc, inner_iters)
                S = torch.cat([Sn, S[:, n:]], dim=1)
            else:
                S, acc = _ss.inner_sweeps_gather(S, fields, partner, rb,
                                                 self_p, acc, inner_iters, K)
        acc3 = (acc[0], acc[1], acc[2])
        if return_state:
            return (S, acc3) if return_acc else S
        out = unpack_body_state(S)
        return out + (acc3,) if return_acc else out

    # the plain inner scan of the JAX package, as is
    gather_idx = _ss.partner_index(rc.partner, K, M)

    def partner_term(S):
        return Vec3(*_ss.partner_term(S, gather_idx, rb_k, R_tot))

    acc_n, acc_t1, acc_t2 = acc0
    for k in range(iters):
        frozen = (partner_term0 if (k == 0 and partner_term0 is not None)
                  else partner_term(S))
        for _ in range(inner_iters):
            dv = frozen - self_term(S)
            f1, f2, acc_t1, acc_t2 = _friction_impulses(rc, dv, acc_t1,
                                                        acc_t2, acc_n)
            if two_phase:
                S = apply_self(S, rc.t1 * f1 + rc.t2 * f2)
                dv = frozen - self_term(S)
                fn, acc_n = _normal_impulse(rc, dv, acc_n)
                S = apply_self(S, rc.normal * fn)
            else:
                fn, acc_n = _normal_impulse(rc, dv, acc_n)
                S = apply_self(S, rc.t1 * f1 + rc.t2 * f2 + rc.normal * fn)
    if return_state:
        return (S, (acc_n, acc_t1, acc_t2)) if return_acc else S
    v_out, o_out = unpack_body_state(S)
    if return_acc:
        return v_out, o_out, (acc_n, acc_t1, acc_t2)
    return v_out, o_out

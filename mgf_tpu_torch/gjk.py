"""GJK distance + EPA penetration, as fixed-iteration batched loops on
tensors (counterpart of ``mgf_tpu.gjk``; reference: simplex.rs).

The reference's vtable simplex state machine (simplex.rs:30-415) is a
branch-free simplex of four explicit support-point slots evolved for a fixed
``GJK_MAX_ITERS`` iterations; EPA's growable triangle pool and hash-based
horizon edge map (simplex.rs:417-553) are a fixed-capacity masked triangle
table with all-pairs edge cancellation, run for ``EPA_MAX_ITERS``
iterations.  Both loops have a fixed count and no host sync: a lane that has
finished is frozen by its ``active`` mask, as the JAX package's
``fori_loop`` lanes are, so a batch gives every pair the answer it would
get alone.

Everything is batched: every tensor carries the batch shape of the support
directions, and EPA's tables a leading slot axis.  The parity points the JAX
package documents hold here unchanged: the relative duality-gap termination
(a divergence from simplex.rs:194), the padding of an origin-enclosing
simplex to a tetrahedron, the tetrahedron-or-octahedron EPA seed and the
barycentric witness recovery (simplex.rs:456-553).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from mgf_tpu_torch.collision import Contact
from mgf_tpu_torch.geom import Triangle, triangle_barycentric
from mgf_tpu_torch.math3d import (
    COLLISION_EPSILON, Vec3, cross, dot, magnitude2, perpendicular, safe_div,
    safe_normalize, tree_map, vzeros_like, where_vec,
)

GJK_MAX_ITERS = 48
EPA_MAX_TRIS = 64
EPA_MAX_ITERS = 32


class SupportPoint(NamedTuple):
    """Minkowski point + witness points on both shapes (geom.rs:1077-1097)."""
    p: Vec3
    a: Vec3
    b: Vec3


def minkowski_support(support_a: Callable, support_b: Callable):
    """Support of the Minkowski difference A - B (geom.rs:1099-1133)."""
    def f(d: Vec3) -> SupportPoint:
        pa = support_a(d)
        pb = support_b(-d)
        return SupportPoint(p=pa - pb, a=pa, b=pb)
    return f


def _sp_where(cond, s1: SupportPoint, s2: SupportPoint) -> SupportPoint:
    return SupportPoint(p=where_vec(cond, s1.p, s2.p),
                        a=where_vec(cond, s1.a, s2.a),
                        b=where_vec(cond, s1.b, s2.b))


def _i32(cond, a: int, b):
    """torch.where(cond, a, b) as int32 (JAX's weakly typed int32)."""
    return torch.where(cond, a, b).to(torch.int32)


# ---------------------------------------------------------------------------
# Johnson-style sub-simplex reductions (simplex.rs:224-415)
# ---------------------------------------------------------------------------

def _edge_reduce(s0: SupportPoint, s1: SupportPoint):
    """EdgeSimplex::min_norm (simplex.rs:243-257).
    Returns (closest, new_s0, new_s1, count_next)."""
    ab = s1.p - s0.p
    t = dot(ab, -s0.p)
    denom = magnitude2(ab)
    past_b = t >= denom
    before_a = t <= 0.0
    frac = safe_div(t, denom)
    closest = where_vec(before_a, s0.p,
                        where_vec(past_b, s1.p, s0.p + ab * frac))
    new_s0 = _sp_where(past_b & ~before_a, s1, s0)
    count_next = _i32(before_a | past_b, 1, 2)
    return closest, new_s0, s1, count_next


def _face_reduce(s0: SupportPoint, s1: SupportPoint, s2: SupportPoint):
    """FaceSimplex::min_norm (simplex.rs:271-331).
    Returns (closest, new_s0, new_s1, new_s2, count_next)."""
    a, b, c = s0.p, s1.p, s2.p
    ab = b - a
    ac = c - a
    ap = -a
    d1 = dot(ab, ap)
    d2 = dot(ac, ap)
    bp = -b
    d3 = dot(ab, bp)
    d4 = dot(ac, bp)
    cp = -c
    d5 = dot(ab, cp)
    d6 = dot(ac, cp)
    vc = d1 * d4 - d3 * d2
    vb = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4

    r_a = (d1 <= 0.0) & (d2 <= 0.0)
    r_b = (d3 >= 0.0) & (d4 <= d3)
    r_ab = (vc <= 0.0) & (d1 >= 0.0) & (d3 <= 0.0)
    r_c = (d6 >= 0.0) & (d5 <= d6)
    r_ac = (vb <= 0.0) & (d2 >= 0.0) & (d6 <= 0.0)
    r_bc = (va <= 0.0) & ((d4 - d3) >= 0.0) & ((d5 - d6) >= 0.0)

    p_ab = a + ab * safe_div(d1, d1 - d3)
    p_ac = a + ac * safe_div(d2, d2 - d6)
    p_bc = b + (c - b) * safe_div(d4 - d3, (d4 - d3) + (d5 - d6))
    denom = va + vb + vc
    p_face = a + ab * safe_div(vb, denom) + ac * safe_div(vc, denom)

    # priority order of the reference's early returns
    sel_a = r_a
    sel_b = r_b & ~sel_a
    sel_ab = r_ab & ~sel_a & ~sel_b
    sel_c = r_c & ~sel_a & ~sel_b & ~sel_ab
    sel_ac = r_ac & ~sel_a & ~sel_b & ~sel_ab & ~sel_c
    sel_bc = r_bc & ~sel_a & ~sel_b & ~sel_ab & ~sel_c & ~sel_ac
    sel_face = ~(sel_a | sel_b | sel_ab | sel_c | sel_ac | sel_bc)

    closest = p_face
    closest = where_vec(sel_bc, p_bc, closest)
    closest = where_vec(sel_ac, p_ac, closest)
    closest = where_vec(sel_c, c, closest)
    closest = where_vec(sel_ab, p_ab, closest)
    closest = where_vec(sel_b, b, closest)
    closest = where_vec(sel_a, a, closest)

    # slot shuffles (simplex.rs:291, 307, 315, 323)
    new_s0 = _sp_where(sel_b, s1, _sp_where(sel_c | sel_bc, s2, s0))
    new_s1 = _sp_where(sel_ac, s2, s1)
    count_next = _i32(sel_a | sel_b | sel_c, 1, _i32(sel_face, 3, 2))
    return closest, new_s0, new_s1, s2, count_next


def _origin_outside_plane(a: Vec3, b: Vec3, c: Vec3, d: Vec3):
    """simplex.rs:340-347."""
    n = cross(b - a, c - a)
    return (dot(-a, n)) * (dot(d - a, n)) < 0.0


def _volume_reduce(s0, s1, s2, s3):
    """VolumeSimplex::min_norm (simplex.rs:353-408).
    Returns (closest, s0', s1', s2', s3', count_next, enclosed)."""
    x = s0.p.x
    best = (vzeros_like(s0.p), torch.full_like(x, float("inf")), s0, s1, s2,
            s3, torch.ones(x.shape, dtype=torch.int32, device=x.device))
    tested_any = torch.zeros(x.shape, dtype=torch.bool, device=x.device)

    def consider(best, tested_any, f0, f1, f2, f3, outside):
        closest, n0, n1, n2, cnt = _face_reduce(f0, f1, f2)
        d = magnitude2(closest)
        take = outside & (d < best[1])
        new_best = (where_vec(take, closest, best[0]),
                    torch.where(take, d, best[1]),
                    _sp_where(take, n0, best[2]),
                    _sp_where(take, n1, best[3]),
                    _sp_where(take, n2, best[4]),
                    _sp_where(take, f3, best[5]),
                    torch.where(take, cnt, best[6]))
        return new_best, tested_any | outside

    a, b, c, d = s0, s1, s2, s3
    av, bv, cv, dv = a.p, b.p, c.p, d.p
    best, tested_any = consider(best, tested_any, a, b, c, d,
                                _origin_outside_plane(av, bv, cv, dv))
    best, tested_any = consider(best, tested_any, a, c, d, b,
                                _origin_outside_plane(av, cv, dv, bv))
    best, tested_any = consider(best, tested_any, a, d, b, c,
                                _origin_outside_plane(av, dv, bv, cv))
    best, tested_any = consider(best, tested_any, b, d, c, a,
                                _origin_outside_plane(bv, dv, cv, av))

    enclosed = ~tested_any  # origin inside all faces
    return best[0], best[2], best[3], best[4], best[5], best[6], enclosed


# ---------------------------------------------------------------------------
# GJK main loop (Simplex::closest_point_to_origin, simplex.rs:172-200)
# ---------------------------------------------------------------------------

class GjkResult(NamedTuple):
    closest: Vec3          # closest point on the Minkowski difference
    enclosed: torch.Tensor  # bool: origin inside (shapes penetrate)
    s0: SupportPoint       # final simplex (tetrahedron when enclosed)
    s1: SupportPoint
    s2: SupportPoint
    s3: SupportPoint


def gjk(support: Callable, init_dir: Vec3, max_iters: int = GJK_MAX_ITERS
        ) -> GjkResult:
    """Run GJK from two initial supports along +-init_dir
    (collision.rs:415-417, 508-510), ``max_iters`` iterations."""
    s_a = support(init_dir)
    s_b = support(-init_dir)
    x = s_a.p.x
    zv = vzeros_like(s_a.p)
    zero_sp = SupportPoint(p=zv, a=zv, b=zv)
    s0, s1, s2, s3 = s_a, s_b, zero_sp, zero_sp
    count = torch.full(x.shape, 2, dtype=torch.int32, device=x.device)
    closest_out = zv
    done = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    enclosed = done

    for _ in range(max_iters):
        # min_norm by simplex size
        e_cl, e0, e1, e_cnt = _edge_reduce(s0, s1)
        f_cl, f0, f1, f2, f_cnt = _face_reduce(s0, s1, s2)
        v_cl, v0, v1, v2, v3, v_cnt, v_enc = _volume_reduce(s0, s1, s2, s3)

        is1 = count == 1
        is2 = count == 2
        is3 = count == 3
        is4 = count == 4

        closest = where_vec(is1, s0.p,
                            where_vec(is2, e_cl,
                                      where_vec(is3, f_cl, v_cl)))
        n0 = _sp_where(is2, e0, _sp_where(is3, f0, _sp_where(is4, v0, s0)))
        n1 = _sp_where(is2, e1, _sp_where(is3, f1, _sp_where(is4, v1, s1)))
        n2 = _sp_where(is3, f2, _sp_where(is4, v2, s2))
        n3 = _sp_where(is4, v3, s3)
        cnt_next = _i32(is1, 1, _i32(is2, e_cnt, _i32(is3, f_cnt, v_cnt)))

        mag2 = magnitude2(closest)
        # Origin enclosed (or reduced onto the simplex): rebuild a
        # non-degenerate tetrahedron around the straddling edge, two
        # supports perpendicular to it, the 4th picked by max |volume|
        # (the JAX package's replacement for simplex.rs:179-189).
        enc_now = (mag2 < COLLISION_EPSILON) | (is4 & v_enc)
        zero = torch.zeros_like(mag2)
        e_axis = safe_normalize(n1.p - n0.p,
                                Vec3(torch.ones_like(mag2), zero, zero))
        u_axis = perpendicular(e_axis)
        w_axis = cross(e_axis, u_axis)
        pad_u = support(u_axis)
        cand_a = support(w_axis)
        cand_b = support(-w_axis)
        cand_c = support(-u_axis)

        n2 = _sp_where(enc_now & (count < 3), pad_u, n2)

        def vol(p3):
            return torch.abs(dot(p3.p - n0.p,
                                 cross(n1.p - n0.p, n2.p - n0.p)))
        va_, vb_, vc_ = vol(cand_a), vol(cand_b), vol(cand_c)
        pad_last = _sp_where((va_ >= vb_) & (va_ >= vc_), cand_a,
                             _sp_where(vb_ >= vc_, cand_b, cand_c))
        n3 = _sp_where(enc_now & (count < 4), pad_last, n3)

        # support along -closest; terminate on the relative duality gap
        # |closest|^2 - closest . sup (the JAX package's DIVERGENCE from
        # simplex.rs:194, which misreports thin penetrating pairs)
        sup = support(-safe_normalize(closest))
        gap = mag2 - dot(closest, sup.p)
        no_progress = gap <= torch.clamp(1e-4 * mag2, min=1e-7)

        done_now = enc_now | no_progress
        active = ~done

        # add the support point at slot cnt_next (EDGE->1, FACE->2, VOL->3)
        add = active & ~done_now
        n1 = _sp_where(add & (cnt_next == 1), sup, n1)
        n2 = _sp_where(add & (cnt_next == 2), sup, n2)
        n3 = _sp_where(add & (cnt_next == 3), sup, n3)
        new_count = torch.where(add, cnt_next + 1, torch.maximum(
            count, 4 * enc_now.to(torch.int32)))
        new_count = _i32(enc_now, 4, new_count)

        s0 = _sp_where(active, n0, s0)
        s1 = _sp_where(active, n1, s1)
        s2 = _sp_where(active, n2, s2)
        s3 = _sp_where(active, n3, s3)
        count = torch.where(active, new_count, count)
        closest_out = where_vec(
            active, where_vec(enc_now, vzeros_like(closest), closest),
            closest_out)
        done = done | (active & done_now)
        enclosed = enclosed | (active & enc_now)

    return GjkResult(closest=closest_out, enclosed=enclosed, s0=s0, s1=s1,
                     s2=s2, s3=s3)


# ---------------------------------------------------------------------------
# EPA (Simplex::compute_contact, simplex.rs:453-553)
# ---------------------------------------------------------------------------

def _slots(sp: SupportPoint, T: int) -> SupportPoint:
    """A (T,) + batch table of zeros shaped like ``sp``: a fresh tensor per
    component, so writing one slot writes no other (an expanded view
    would)."""
    return tree_map(lambda x: torch.zeros((T,) + x.shape, dtype=x.dtype,
                                          device=x.device), sp)


def _write_slot(tbl: SupportPoint, k: int, sp: SupportPoint):
    for t_vec, v_vec in zip(tbl, sp):
        for t_, v_ in zip(t_vec, v_vec):
            t_[k] = v_


def _cat(*trees):
    return tree_map(lambda *xs: torch.cat(xs, dim=0), *trees)


def _take(tree, idx):
    """Gather slot ``idx`` (batch-shaped int64) of every (T,) + batch
    leaf."""
    return tree_map(lambda x: torch.gather(x, 0, idx.unsqueeze(0))[0], tree)


def _take_slots(tree, idx):
    """Gather rows ``idx`` ((T,) + batch int64) of every (E,) + batch
    leaf."""
    return tree_map(lambda x: torch.gather(x, 0, idx), tree)


def epa(support: Callable, res: GjkResult, max_iters: int = EPA_MAX_ITERS,
        max_tris: int = EPA_MAX_TRIS, return_saturated: bool = False):
    """Expand the GJK tetrahedron into the penetration contact.

    Fixed-capacity masked triangle table; horizon edges found by all-pairs
    cancellation (the EdgeMap of simplex.rs:417-450).  Returns the contact
    with points on A and B and the outward penetration normal; with
    ``return_saturated`` also a bool mask of lanes where the triangle table
    overflowed (a horizon edge with no free slot: the normal and depth may
    be degraded).

    The edges cancel only where their stored vertices are bit-equal, so the
    new triangles' vertices are copied with an integer gather (never a
    float product, which could round them)."""
    T = max_tris
    x = res.s0.p.x
    batch = x.shape
    dev = x.device

    # Seed: the GJK tetrahedron where it encloses the origin, else an
    # octahedron of six jittered-axis supports (the jitter de-ties sign(0)
    # corner picks on axis-aligned shapes).
    one = torch.ones(batch, device=dev)
    e1, e2 = 3e-4 * one, 7e-4 * one
    dirs = [Vec3(one, e1, e2), Vec3(-one, -e1, e2),
            Vec3(e2, one, -e1), Vec3(-e2, -one, -e1),
            Vec3(-e1, e2, one), Vec3(e1, -e2, -one)]
    vs = [support(d_) for d_ in dirs]
    oct_interior = vs[0].p
    for v_ in vs[1:]:
        oct_interior = oct_interior + v_.p
    oct_interior = oct_interior * (1.0 / 6.0)

    g0, g1, g2, g3 = res.s0, res.s1, res.s2, res.s3

    def outside(aa, bb, cc, dd):
        nrm = cross(bb - aa, cc - aa)
        return (dot(aa * -1.0, nrm)) * (dot(dd - aa, nrm)) < 0.0

    enc_tet = ~(outside(g0.p, g1.p, g2.p, g3.p)
                | outside(g0.p, g2.p, g3.p, g1.p)
                | outside(g0.p, g3.p, g1.p, g2.p)
                | outside(g1.p, g3.p, g2.p, g0.p))
    tet_interior = (g0.p + g1.p + g2.p + g3.p) * 0.25
    interior = where_vec(enc_tet, tet_interior, oct_interior)

    px, nx, py, ny, pz, nz = vs
    oct_seeds = [(px, py, pz), (px, pz, ny), (px, ny, nz), (px, nz, py),
                 (nx, pz, py), (nx, ny, pz), (nx, nz, ny), (nx, py, nz)]
    tet_seeds = [(g0, g1, g2), (g0, g2, g3), (g0, g3, g1), (g1, g3, g2)]

    bshape = lambda sp: tree_map(lambda v: v.expand(batch), sp)
    t0, t1, t2 = (_slots(res.s0, T) for _ in range(3))
    # slots past T are dropped, as JAX drops out-of-bounds .at[k].set
    for k_ in range(min(8, T)):
        o0, o1, o2 = oct_seeds[k_]
        if k_ < 4:
            ts = tet_seeds[k_]
            o0 = _sp_where(enc_tet, ts[0], o0)
            o1 = _sp_where(enc_tet, ts[1], o1)
            o2 = _sp_where(enc_tet, ts[2], o2)
        _write_slot(t0, k_, bshape(o0))
        _write_slot(t1, k_, bshape(o1))
        _write_slot(t2, k_, bshape(o2))
    valid = torch.zeros((T,) + batch, dtype=torch.bool, device=dev)
    valid[:8] = True
    valid[4:8] &= ~enc_tet

    zero = SupportPoint(p=vzeros_like(res.s0.p), a=vzeros_like(res.s0.p),
                        b=vzeros_like(res.s0.p))
    done = torch.zeros(batch, dtype=torch.bool, device=dev)
    saturated = done
    out_n = vzeros_like(res.s0.p)
    out_dist = torch.zeros(batch, device=dev)
    out_t0 = out_t1 = out_t2 = zero

    def tri_normal_dist(t0, t1, t2):
        raw = cross(t1.p - t0.p, t2.p - t0.p)
        ok = magnitude2(raw) > 1e-12      # degenerate faces never "closest"
        n = safe_normalize(raw)
        # orient outward w.r.t. the seed interior point (winding-robust)
        sgn = torch.where(dot(n, t0.p - interior) >= 0.0, 1.0, -1.0)
        n = n * sgn
        return n, torch.abs(dot(n, t0.p)), ok

    for _ in range(max_iters):
        n, dist, n_ok = tri_normal_dist(t0, t1, t2)    # (T,) + batch
        dist_m = torch.where(valid & n_ok, dist, float("inf"))
        ci = torch.argmin(dist_m, dim=0)               # first minimum
        cn = _take(n, ci)
        cdist = _take(dist, ci)
        c0, c1, c2 = _take(t0, ci), _take(t1, ci), _take(t2, ci)

        sup = support(cn)
        growth = dot(cn, sup.p) - cdist
        conv = growth < COLLISION_EPSILON

        active = ~done
        rec = active & conv
        out_n = where_vec(rec, cn, out_n)
        out_dist = torch.where(rec, cdist, out_dist)
        out_t0 = _sp_where(rec, c0, out_t0)
        out_t1 = _sp_where(rec, c1, out_t1)
        out_t2 = _sp_where(rec, c2, out_t2)

        # expand: remove the triangles facing the support
        facing = valid & (dot(n, sup.p - t0.p) > 0.0)
        grow = active & ~conv

        # horizon edges: the directed edges (t0,t1), (t1,t2), (t2,t0) of
        # the facing triangles; an edge survives unless its reverse is
        # among them, with bit-equal vertices.  match[i, j]: edge i starts
        # where edge j ends (all three components equal); edge j is
        # cancelled iff some i has match[i, j] & match[j, i].  The vertices
        # of edges that do not face are NaN, which equals nothing: that
        # masks both i and j.
        e_a = _cat(t0, t1, t2)                         # (E,) + batch
        e_b = _cat(t1, t2, t0)
        e_ok = torch.cat([facing, facing, facing], dim=0)
        key = lambda c: torch.where(e_ok, c, float("nan"))
        match = key(e_a.p.x)[:, None] == key(e_b.p.x)[None, :]
        match &= key(e_a.p.y)[:, None] == key(e_b.p.y)[None, :]
        match &= key(e_a.p.z)[:, None] == key(e_b.p.z)[None, :]
        # any() over the leading axis, as a max of the bytes (the same
        # answer, ~3x faster than torch.any over a strided axis on the CPU)
        cancelled = (match & match.transpose(0, 1)).view(torch.uint8).amax(
            dim=0).bool()
        horizon = e_ok & ~cancelled                    # (E,) + batch

        # free slots (empty or facing) take the new triangles (sup, a, b)
        # of the horizon edges by rank: slot k of free rank r takes the
        # horizon edge of rank r, found in the running count of horizon
        # edges by a binary search and copied by an integer gather
        free = ~valid | facing                         # (T,) + batch
        free_rank = torch.cumsum(free.to(torch.int32), dim=0,
                                 dtype=torch.int32) - 1
        h_cum = torch.cumsum(horizon.to(torch.int32), dim=0,
                             dtype=torch.int32)
        n_free = free_rank[-1] + 1
        n_horizon = h_cum[-1]
        edge = torch.searchsorted(h_cum.movedim(0, -1).contiguous(),
                                  (free_rank + 1).movedim(0, -1).contiguous())
        edge = torch.clamp(edge.movedim(-1, 0), max=3 * T - 1)
        new_a = _take_slots(e_a, edge)
        new_b = _take_slots(e_b, edge)
        got = free & (free_rank < n_horizon)

        # saturation: a horizon edge with no free slot leaves the polytope
        # non-watertight (the returned normal and depth may be degraded)
        sat_now = grow & (n_horizon > n_free)

        wr = grow & got
        t0 = _sp_where(wr, sup, t0)
        t1 = _sp_where(wr, new_a, t1)
        t2 = _sp_where(wr, new_b, t2)
        valid = torch.where(grow, (valid & ~facing) | wr, valid)
        done = done | rec
        saturated = saturated | sat_now

    # barycentric recovery (simplex.rs:499-507)
    tri_p = Triangle(a=out_t0.p, b=out_t1.p, c=out_t2.p)
    proj = out_n * out_dist
    u, w, v0 = triangle_barycentric(tri_p, proj)
    pa = out_t0.a * v0 + out_t1.a * u + out_t2.a * w
    contact = Contact(a=pa, b=pa - out_n * out_dist, n=out_n,
                      t=torch.zeros_like(out_dist), valid=done)
    if return_saturated:
        return contact, saturated
    return contact


# ---------------------------------------------------------------------------
# public API: Penetrates + generic convex Contacts
# ---------------------------------------------------------------------------

def _axis(batch_ones, k: int) -> Vec3:
    one = torch.ones_like(batch_ones)
    c = [one * 0.0, one * 0.0, one * 0.0]
    c[k] = one
    return Vec3(*c)


def separation(support_a: Callable, support_b: Callable, batch_ones):
    """Minimum separation distance, None-when-penetrating semantics
    (Penetrates::separation, collision.rs:404-425).

    Returns (distance, separated_mask): distance valid where separated.
    ``batch_ones`` is any tensor broadcastable to the batch shape (its
    device is the run's)."""
    diff = minkowski_support(support_a, support_b)
    res = gjk(diff, _axis(batch_ones, 0))      # d = +x (collision.rs:410)
    mag2 = magnitude2(res.closest)
    separated = mag2 >= COLLISION_EPSILON
    return torch.sqrt(torch.clamp(mag2, min=0.0)), separated


def contact_convex_convex_ex(support_a: Callable, support_b: Callable,
                             batch_ones):
    """:func:`contact_convex_convex` and the EPA saturation mask
    (capacity-overflow observability)."""
    diff = minkowski_support(support_a, support_b)
    res = gjk(diff, _axis(batch_ones, 1))      # d = +y (collision.rs:503)
    mag2 = magnitude2(res.closest)
    touching = mag2 <= COLLISION_EPSILON
    c, sat = epa(diff, res, return_saturated=True)
    return c._replace(valid=c.valid & touching & res.enclosed), sat


def contact_convex_convex(support_a: Callable, support_b: Callable,
                          batch_ones) -> Contact:
    """Discrete contact between any two convex shapes via GJK + EPA
    (generic Contacts impl, collision.rs:497-519).  t is always 0."""
    return contact_convex_convex_ex(support_a, support_b, batch_ones)[0]

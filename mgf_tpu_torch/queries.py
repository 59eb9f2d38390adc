"""World queries: overlap queries and ray casts over body sets and meshes
(counterpart of ``mgf_tpu.queries``; reference: the BVH query surface,
bvh.rs:283-369).

Where mgf walks a pointer tree with a callback, these return fixed-shape
masks and first hits over the whole body batch:

* :func:`query_aabb` — bodies whose fat bounds overlap a query AABB
  (BVH::query, bvh.rs:283-309);
* :func:`raytrace_bodies` — first-hit ray cast against every body collider
  (BVH::raytrace, bvh.rs:345-369), a dense scan;
* :func:`build_body_grid` + :func:`raytrace_bodies_grid` — the
  grid-accelerated form (3-D DDA: only bodies in the cells a ray crosses are
  tested);
* :func:`raytrace_mesh` / :func:`raytrace_mesh_grid` — the same pair for
  triangle meshes.

The JAX functions take one ray and are ``vmap``-ped by their callers; these
take a batch of rays, ``p`` and ``d`` of any shape (0-d for one ray), and
return results of that shape.  A batch gives each ray its single-ray
answer: the dense scans are chunked over rays only, and the DDA freezes a
ray's whole state once it is done, as ``vmap`` of the JAX ``while_loop``
does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mgf_tpu_torch.broadphase import _bucket_ranks, swept_fat_bounds
from mgf_tpu_torch.collision import (
    Intersection, intersect_capsule, intersect_sphere, intersect_triangle,
)
from mgf_tpu_torch.geom import AABB, Capsule, Sphere
from mgf_tpu_torch.math3d import Vec3, tree_map
from mgf_tpu_torch.mesh import Mesh, MeshGrid, mesh_triangles
from mgf_tpu_torch.physics import SHAPE_SPHERE, colliders
from mgf_tpu_torch.world import WorldConfig, _body_bounds, shape_view

# A dense scan holds ~30 temporaries of (rays, bodies) lanes
# (intersect_capsule); chunks of at most this many lanes keep each one at
# 512 MiB of float32
DENSE_LANES = 1 << 27
# the DDA checks whether any ray is still marching every this many cells
# (a host sync; the iterations between two checks are masked no-ops for the
# rays that are done)
DDA_SYNC_EVERY = 8


def query_aabb(state, box: AABB, fatten: float = 0.0):
    """Boolean mask of bodies whose (fattened swept) bounds overlap ``box``:
    the broadphase query of world.rs:260-264 against an arbitrary AABB."""
    cfg = WorldConfig(shape_mode="mixed")
    bounds = swept_fat_bounds(_body_bounds(cfg, shape_view(state)),
                              state.delta, fatten)
    d = bounds.c - box.c
    s = bounds.r + box.r
    return ((torch.abs(d.x) <= s.x) & (torch.abs(d.y) <= s.y)
            & (torch.abs(d.z) <= s.z))


def _rays(p: Vec3, d: Vec3, dt):
    """Flatten a ray batch of any shape to (R,); returns the shape.  A
    tensor ``dt`` is flattened with the rays (a float passes through)."""
    shape = torch.broadcast_shapes(*(c.shape for c in (*p, *d)))
    flat = lambda c: c.expand(shape).reshape(-1)
    if isinstance(dt, torch.Tensor):
        dt = flat(dt)
    return Vec3(*map(flat, p)), Vec3(*map(flat, d)), dt, shape


def _dense_chunks(n_rays: int, n_targets: int):
    step = max(1, DENSE_LANES // max(n_targets, 1))
    return [(lo, min(lo + step, n_rays)) for lo in range(0, n_rays, step)]


def _dt_col(dt, lo=0, hi=None):
    """A flat ``dt`` as a (rays, 1) column of rays lo:hi (a float passes
    through)."""
    return dt[lo:hi, None] if isinstance(dt, torch.Tensor) else dt


def raytrace_bodies(state, p: Vec3, d: Vec3, dt=float("inf")) -> tuple:
    """First-hit ray/segment cast against every body's collider.

    Returns (Intersection, body_index) of the rays' shape.  Equivalent to
    BVH::raytrace + per-leaf Intersects (bvh.rs:345-369), evaluated
    densely over (rays, bodies), chunked over the rays.  A ray that hits
    nothing reports body 0, as ``jnp.argmin`` of all-inf does."""
    spheres, capsules = colliders(state)
    is_sphere = state.shape_type == SHAPE_SPHERE
    p, d, dt, shape = _rays(p, d, dt)
    t_best, t_raw_best, best = [], [], []
    for lo, hi in _dense_chunks(p.x.shape[0], state.n_bodies):
        col = lambda v: Vec3(*(c[lo:hi, None] for c in v))
        pc, dc, dtc = col(p), col(d), _dt_col(dt, lo, hi)
        i_s = intersect_sphere(pc, dc, dtc, spheres)
        i_c = intersect_capsule(pc, dc, dtc, capsules)
        hit = torch.where(is_sphere, i_s.hit, i_c.hit)
        t_raw = torch.where(is_sphere, i_s.t, i_c.t)
        t = torch.where(hit, t_raw, float("inf"))
        k = torch.argmin(t, dim=1, keepdim=True)      # first minimum
        t_best.append(torch.gather(t, 1, k)[:, 0])
        t_raw_best.append(torch.gather(t_raw, 1, k)[:, 0])
        best.append(k[:, 0])
    t = torch.cat(t_best)
    # the hit point from the picked body's t, taken before the hit mask (as
    # the JAX package picks its point)
    inter = Intersection(p=p + d * torch.cat(t_raw_best), t=t,
                         hit=torch.isfinite(t))
    return (tree_map(lambda x: x.reshape(shape), inter),
            torch.cat(best).reshape(shape))


class BodyGrid(NamedTuple):
    """Cell -> packed-collider table for ray casts against the body set.

    Each body is binned into EVERY cell its bound AABB overlaps (at most 27
    cells for a body up to one cell in reach, masked to the actual span), so
    the DDA tests exactly the visited cell.  A row packs the whole collider,
    [cx cy cz r ax ay az dx dy dz is_sphere idx], so a visited cell is one
    (cap, 12) row fetch.

    ``dims`` is per axis (each a power of two): a cell's modulus must
    exceed the OCCUPIED span on that axis, or distinct occupied cells alias
    and overflow the bucket cap (aliasing on the query side, e.g. a ray far
    above the pile, keeps the answer exact: candidates are re-tested)."""
    table: torch.Tensor     # (dims[0]*dims[1]*dims[2], cap, 12) float32
    cell_size: float
    dims: tuple
    overflow: torch.Tensor  # () int32: insertions dropped from full cells


def build_body_grid(state, cell_size: float, dim=64, cap: int = 8,
                    dims: tuple = None) -> BodyGrid:
    """Bin body colliders into a modular cell grid (the BVH build of
    bvh.rs:100-161, amortized over a ray batch; rebuild after stepping).
    ``dims`` (dx, dy, dz) overrides the cubic ``dim``.

    Built as the JAX package builds it: a stable sort of the insertions by
    cell, each one's rank in its cell, a scatter of the first ``cap``.  The
    JAX scatter also writes an empty row (index -1) for every insertion past
    ``cap`` to its cell's last slot, and the later writes win: a cell that
    overflows keeps ``cap - 1`` bodies.  The port writes that row
    explicitly."""
    spheres, capsules = colliders(state)
    n = state.n_bodies
    dev = state.x.x.device
    if dims is None:
        dims = (int(dim),) * 3
    dx_, dy_, dz_ = dims
    ncell = dx_ * dy_ * dz_
    reach = state.shape_r + state.shape_half_h
    cc = lambda comp: torch.floor(comp / cell_size).to(torch.int32)
    lo = [cc(state.x.x - reach), cc(state.x.y - reach),
          cc(state.x.z - reach)]
    hi = [cc(state.x.x + reach), cc(state.x.y + reach),
          cc(state.x.z + reach)]
    alive = state.shape_r > 0.0          # capacity pads / killed bodies
    hs, oks = [], []
    for ox in (0, 1, 2):
        for oy in (0, 1, 2):
            for oz in (0, 1, 2):
                cx, cy, cz = lo[0] + ox, lo[1] + oy, lo[2] + oz
                oks.append(alive & (cx <= hi[0]) & (cy <= hi[1])
                           & (cz <= hi[2]))
                hs.append((((cx & (dx_ - 1)) * dy_ + (cy & (dy_ - 1)))
                           * dz_ + (cz & (dz_ - 1))))
    h = torch.cat(hs)
    ins_ok = torch.cat(oks)
    body = torch.arange(n, device=dev).repeat(27)
    hk = torch.where(ins_ok, h, ncell)                # invalid sort last
    order = torch.argsort(hk, stable=True)
    sorted_h = hk[order]
    rank = _bucket_ranks(sorted_h)
    in_table = sorted_h < ncell
    ok = (rank < cap) & in_table
    over = (rank >= cap) & in_table
    rows = torch.stack([
        spheres.c.x, spheres.c.y, spheres.c.z, state.shape_r,
        capsules.a.x, capsules.a.y, capsules.a.z,
        capsules.d.x, capsules.d.y, capsules.d.z,
        (state.shape_type == SHAPE_SPHERE).to(torch.float32),
        torch.arange(n, dtype=torch.float32, device=dev)], dim=-1)  # (N, 12)
    empty = torch.zeros(12, device=dev)
    empty[11] = -1.0
    # one extra sentinel cell takes the insertions JAX drops (mode='drop')
    table = empty.repeat(ncell + 1, cap, 1)
    slot = torch.clamp(rank, max=cap - 1).long()
    table[torch.where(ok, sorted_h, ncell).long(), slot] = rows[body[order]]
    table[torch.where(over, sorted_h, ncell).long(), cap - 1] = empty
    return BodyGrid(table=table[:ncell], cell_size=cell_size, dims=dims,
                    overflow=torch.sum(over).to(torch.int32))


def _dda(p: Vec3, d: Vec3, dt, max_steps: int, cs: float, cell_hits):
    """3-D DDA cell marching for a batch of (R,) rays.

    ``cell_hits(cell) -> (t, idx)`` gives, for each ray's current cell
    ((3, R) int32), its nearest candidate hit t (inf for none) and that
    candidate's id.  Every carry update is masked by the ray being active
    at the top of the iteration (not done, under ``max_steps``), which is
    what ``vmap`` of the JAX single-ray ``while_loop`` does: a ray that is
    done keeps its state while the others march on.  Returns (best_t,
    best_id, steps), steps being the iterations each ray took."""
    eps = 1e-12
    comps = (d.x, d.y, d.z)
    inv = torch.stack([torch.where(torch.abs(c) > eps, 1.0 / torch.where(
        torch.abs(c) > eps, c, 1.0), float("inf")) for c in comps])
    stepv = torch.stack([torch.where(c >= 0.0, 1, -1).to(torch.int32)
                         for c in comps])
    cell = torch.stack([torch.floor(c / cs).to(torch.int32)
                        for c in (p.x, p.y, p.z)])
    pos = torch.stack([p.x, p.y, p.z])
    edge = (cell.to(torch.float32) + (torch.stack(comps) >= 0.0)) * cs
    tmax = torch.where(torch.isfinite(inv), (edge - pos) * inv,
                       float("inf"))
    n = p.x.shape[0]
    dev = p.x.device
    best_t = torch.full((n,), float("inf"), device=dev)
    best_b = torch.full((n,), -1, dtype=torch.int32, device=dev)
    t_entry = torch.zeros(n, device=dev)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    i = torch.zeros(n, dtype=torch.int32, device=dev)
    step_len = torch.abs(inv) * cs
    for k in range(max_steps):
        if k % DDA_SYNC_EVERY == 0 and not bool(
                ((~done) & (i < max_steps)).any()):
            break
        active = (~done) & (i < max_steps)
        tt, idx = cell_hits(cell)
        better = tt < best_t
        new_t = torch.where(better, tt, best_t)
        new_b = torch.where(better, idx, best_b)

        ax = torch.argmin(tmax, dim=0, keepdim=True)   # first minimum
        t_exit = torch.gather(tmax, 0, ax)[0]
        new_done = done | (new_t <= t_exit) | (t_entry > dt)
        move = active & ~new_done
        onehot = torch.arange(3, device=dev)[:, None] == ax
        cell = torch.where(onehot & move, cell + stepv, cell)
        tmax = torch.where(onehot & move, tmax + step_len, tmax)
        best_t = torch.where(active, new_t, best_t)
        best_b = torch.where(active, new_b, best_b)
        t_entry = torch.where(move, t_exit, t_entry)
        done = torch.where(active, new_done, done)
        i = i + active.to(torch.int32)
    return best_t, best_b, i


def _grid_cast(p: Vec3, d: Vec3, dt, max_steps, cs, cell_hits):
    p, d, dt, shape = _rays(p, d, dt)
    best_t, best_id, steps = _dda(p, d, dt, max_steps, cs,
                                  cell_hits(p, d, dt))
    hit = torch.isfinite(best_t) & (best_t <= dt)
    out = Intersection(p=p + d * best_t, t=best_t, hit=hit)
    return (tree_map(lambda x: x.reshape(shape), out),
            best_id.reshape(shape), steps.reshape(shape))


def _cap_min(tt, ids):
    """(t, id) of each row's first minimum over the cap axis."""
    k = torch.argmin(tt, dim=1, keepdim=True)
    return (torch.gather(tt, 1, k)[:, 0],
            torch.gather(ids, 1, k)[:, 0])


def raytrace_bodies_grid_steps(grid: BodyGrid, p: Vec3, d: Vec3,
                               dt=float("inf"), max_steps: int = 192):
    """:func:`raytrace_bodies_grid` and the DDA iterations each ray
    took."""
    dx_, dy_, dz_ = grid.dims

    def cell_hits(p, d, dt):
        col = lambda v: Vec3(*(c[:, None] for c in v))
        pc, dc, dtc = col(p), col(d), _dt_col(dt)

        def hits(cell):
            h = (((cell[0] & (dx_ - 1)) * dy_ + (cell[1] & (dy_ - 1))) * dz_
                 + (cell[2] & (dz_ - 1)))
            r = grid.table[h.long()]                  # (R, cap, 12)
            sph = Sphere(c=Vec3(r[..., 0], r[..., 1], r[..., 2]),
                         r=r[..., 3])
            capsule = Capsule(a=Vec3(r[..., 4], r[..., 5], r[..., 6]),
                              d=Vec3(r[..., 7], r[..., 8], r[..., 9]),
                              r=r[..., 3])
            is_sphere = r[..., 10] > 0.5
            idx = r[..., 11].to(torch.int32)
            i_s = intersect_sphere(pc, dc, dtc, sph)
            i_c = intersect_capsule(pc, dc, dtc, capsule)
            hit = torch.where(is_sphere, i_s.hit, i_c.hit) & (idx >= 0)
            tt = torch.where(hit, torch.where(is_sphere, i_s.t, i_c.t),
                             float("inf"))
            return _cap_min(tt, idx)
        return hits

    return _grid_cast(p, d, dt, max_steps, grid.cell_size, cell_hits)


def raytrace_bodies_grid(grid: BodyGrid, p: Vec3, d: Vec3, dt=float("inf"),
                         max_steps: int = 192) -> tuple:
    """First-hit ray/segment cast against the body set via 3-D DDA cell
    marching over a :func:`build_body_grid` table: the log-ish
    BVH::raytrace (bvh.rs:345-369) in place of :func:`raytrace_bodies`'s
    dense O(N) scan for large worlds.  Exact for bodies within the grid's
    insertion reach.

    Returns (Intersection, body_index) like :func:`raytrace_bodies`."""
    return raytrace_bodies_grid_steps(grid, p, d, dt, max_steps)[:2]


def raytrace_mesh_grid(m: Mesh, grid: MeshGrid, p: Vec3, d: Vec3,
                       dt=float("inf"), max_steps: int = 192) -> tuple:
    """First-hit ray cast through a :class:`mgf_tpu_torch.mesh.MeshGrid` by
    3-D DDA cell marching (the BVH::raytrace equivalent, bvh.rs:345-369,
    for large meshes): only the faces in the cells a ray crosses are
    tested, and a confirmed hit inside the traversed interval ends the
    march.  Exact regardless of grid aliasing (candidates are re-tested
    with the real triangle intersection).

    Returns (Intersection, face_index) like :func:`raytrace_mesh`."""
    tris = mesh_triangles(m)
    mmask = grid.dim - 1

    def cell_hits(p, d, dt):
        col = lambda v: Vec3(*(c[:, None] for c in v))
        pc, dc, dtc = col(p), col(d), _dt_col(dt)

        def hits(cell):
            h = (((cell[0] & mmask) * grid.dim + (cell[1] & mmask))
                 * grid.dim + (cell[2] & mmask))
            faces = grid.table[h.long()]              # (R, cap)
            safe = torch.clamp(faces, min=0).long()
            tri = tree_map(lambda x: x[safe], tris)
            inter = intersect_triangle(pc, dc, dtc, tri)
            tt = torch.where(inter.hit & (faces >= 0), inter.t,
                             float("inf"))
            return _cap_min(tt, faces)
        return hits

    return _grid_cast(p, d, dt, max_steps, grid.cell_size, cell_hits)[:2]


def raytrace_mesh(m: Mesh, p: Vec3, d: Vec3, dt=float("inf")) -> tuple:
    """First-hit ray/segment cast against a triangle mesh, densely over
    (rays, faces), chunked over the rays.

    Returns (Intersection, face_index): the raytrace path of Compound and
    Mesh queries (the mesh BVH raytrace equivalent)."""
    tris = mesh_triangles(m)
    p, d, dt, shape = _rays(p, d, dt)
    pts, ts, bests = [], [], []
    for lo, hi in _dense_chunks(p.x.shape[0], m.n_faces):
        col = lambda v: Vec3(*(c[lo:hi, None] for c in v))
        inter = intersect_triangle(col(p), col(d), _dt_col(dt, lo, hi), tris)
        t = torch.where(inter.hit, inter.t, float("inf"))
        best = torch.argmin(t, dim=1, keepdim=True)   # first minimum
        pick = lambda x: torch.gather(x.expand(t.shape), 1, best)[:, 0]
        pts.append(torch.stack([pick(c) for c in inter.p]))
        ts.append(pick(t))
        bests.append(best[:, 0])
    t = torch.cat(ts)
    out = Intersection(p=Vec3(*torch.cat(pts, dim=1)), t=t,
                       hit=torch.isfinite(t))
    return (tree_map(lambda x: x.reshape(shape), out),
            torch.cat(bests).reshape(shape))

"""Cell-grid broadphase (counterpart of the ``packed`` and ``fat27x4`` parts
of ``mgf_tpu.broadphase``).

**packed** (the generic branch): :func:`build_grid` bins body indices into
a ``(ncell, bucket_cap)`` table; :func:`neighbor_candidates` gathers the
27 neighbour buckets of every body; :func:`refine_pairs` culls them by
swept-AABB overlap and keeps the ``max_pairs`` closest.  ``lax.top_k``
keeps the lower index among equal scores, and an unjittered lattice has
many equal distances, so the selection is a stable descending sort.

**fat27x4** (the flagship): bodies are binned by swept-AABB center into
cells of side ``cell_size``, addressed modulo power-of-two grid
dimensions: a dense
``(ncell, bucket_cap * 4)`` float table whose bucket rows carry the
occupants' centers and indices inline (component-blocked
``[x*cap | y*cap | z*cap | idx*cap]``).  Building it is a stable sort +
rank + scatter; candidates for a body are the bucket rows of its 27
neighbor cells, culled by an AABB test and ranked by a fused int32 key
(14-bit quantized distance | 17-bit body index).

Bit-exactness with the JAX package rests on four details, each kept here:
the sort is stable (ranks inside a bucket decide overflow); the run start
is a cumulative max; rows that JAX drops with ``mode='drop'`` go to one
sentinel slot that is sliced off; and the key arithmetic stays in int32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mgf_tpu_torch.geom import AABB
from mgf_tpu_torch.math3d import Vec3, vmax, vmin


class GridConfig(NamedTuple):
    """Static broadphase configuration (python scalars).  ``dim`` is one
    power of two (cubic table) or a per-axis (dx, dy, dz) tuple of them."""
    cell_size: float
    dim: object = 64
    bucket_cap: int = 4


def grid_dims(cfg: GridConfig):
    d = cfg.dim
    return d if isinstance(d, tuple) else (d, d, d)


def grid_ncells(cfg: GridConfig) -> int:
    dx, dy, dz = grid_dims(cfg)
    return dx * dy * dz


def _cell_coords(centers: Vec3, cfg: GridConfig):
    f = lambda c: torch.floor(c / cfg.cell_size).to(torch.int32)
    return f(centers.x), f(centers.y), f(centers.z)


def _bucket_index(cx, cy, cz, cfg: GridConfig):
    dx, dy, dz = grid_dims(cfg)  # powers of two
    return ((cx & (dx - 1)) * dy + (cy & (dy - 1))) * dz + (cz & (dz - 1))


def _bucket_ranks(sorted_h):
    """Rank of each element within its run of equal keys (a cummax of run
    starts, as the JAX package's associative max scan)."""
    n = sorted_h.shape[0]
    ar = torch.arange(n, dtype=torch.int32, device=sorted_h.device)
    is_start = torch.ones_like(sorted_h, dtype=torch.bool)
    is_start[1:] = sorted_h[1:] != sorted_h[:-1]
    run_start = torch.cummax(torch.where(is_start, ar, 0), dim=0).values
    return ar - run_start


class GridTable(NamedTuple):
    table: torch.Tensor     # (ncell, bucket_cap) int32 body index or -1
    overflow: torch.Tensor  # () int32: bodies dropped from full buckets


def _binned(centers: Vec3, cfg: GridConfig, valid):
    """Bucket of every body (``ncell`` for rows kept out of the table),
    the stable sort by bucket, and each sorted entry's rank in its
    bucket."""
    ncell = grid_ncells(cfg)
    cx, cy, cz = _cell_coords(centers, cfg)
    h = _bucket_index(cx, cy, cz, cfg)
    if valid is not None:
        h = torch.where(valid, h, ncell)
    order = torch.argsort(h, stable=True)
    sorted_h = h[order]
    return order, sorted_h, _bucket_ranks(sorted_h)


def build_grid(centers: Vec3, cfg: GridConfig, valid=None) -> GridTable:
    """Bin body indices into the modular grid.  ``valid`` (N,) bool keeps
    rows out of the table (and out of the overflow count)."""
    ncell = grid_ncells(cfg)
    cap = cfg.bucket_cap
    order, sorted_h, rank = _binned(centers, cfg, valid)
    in_table = sorted_h < ncell
    ok = (rank < cap) & in_table
    n_over = torch.sum((rank >= cap) & in_table).to(torch.int32)
    # one extra sentinel slot takes the rows JAX drops (mode='drop')
    table = torch.full((ncell * cap + 1,), -1, dtype=torch.int32,
                       device=sorted_h.device)
    slot = sorted_h * cap + torch.clamp(rank, max=cap - 1)
    table[torch.where(ok, slot, ncell * cap).long()] = torch.where(
        ok, order.to(torch.int32), -1)
    return GridTable(table=table[:ncell * cap].reshape(ncell, cap),
                     overflow=n_over)


_OFFSETS = [(dx, dy, dz)
            for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]


def neighbor_candidates(centers: Vec3, table: GridTable, cfg: GridConfig):
    """(N, 27*bucket_cap) candidate partner indices (-1 = empty slot)."""
    cx, cy, cz = _cell_coords(centers, cfg)
    cols = [table.table[_bucket_index(cx + dx, cy + dy, cz + dz, cfg).long()]
            for (dx, dy, dz) in _OFFSETS]
    return torch.cat(cols, dim=-1)


def pack_bounds(bounds: AABB):
    """AABB center + conservative cube radius as one (N, 4) tensor, so the
    cull gathers one row per candidate."""
    r_eff = torch.maximum(bounds.r.x, torch.maximum(bounds.r.y, bounds.r.z))
    return torch.stack([bounds.c.x, bounds.c.y, bounds.c.z, r_eff], dim=-1)


def refine_pairs(bounds: AABB, cand, max_pairs: int, ordered: bool = True):
    """Cull candidates by swept-AABB overlap; keep the closest
    ``max_pairs`` per body.  ``cand`` is the (N, K) candidate matrix of
    body indices; ``ordered`` keeps only partners of smaller index (the
    reference's dedupe), ``ordered=False`` both directions.  Returns
    (partner (N, max_pairs) int32, valid)."""
    self_rows = torch.arange(cand.shape[0], dtype=torch.int32,
                             device=cand.device)
    packed = pack_bounds(bounds)
    gb = packed[torch.clamp(cand, min=0).long()]     # (N, K, 4): ONE gather
    sb = packed[:, None, :]                          # (N, 1, 4)
    if ordered:
        ok = (cand >= 0) & (cand < self_rows[:, None])
    else:
        ok = (cand >= 0) & (cand != self_rows[:, None])
    dx = gb[..., 0] - sb[..., 0]
    dy = gb[..., 1] - sb[..., 1]
    dz = gb[..., 2] - sb[..., 2]
    rr = gb[..., 3] + sb[..., 3]
    overlap = ((torch.abs(dx) <= rr) & (torch.abs(dy) <= rr)
               & (torch.abs(dz) <= rr))
    ok = ok & overlap
    d2 = dx * dx + dy * dy + dz * dz
    score = torch.where(ok, -d2, -float("inf"))
    cand_ok = torch.where(ok, cand, -1)
    if cand.shape[1] <= max_pairs:
        partner = torch.nn.functional.pad(
            cand_ok, (0, max_pairs - cand.shape[1]), value=-1)
        return partner, partner >= 0
    # lax.top_k order: descending, the lower index first among equals
    top, idx = torch.sort(score, dim=1, descending=True, stable=True)
    top, idx = top[:, :max_pairs], idx[:, :max_pairs]
    valid = torch.isfinite(top)
    partner = torch.gather(cand_ok, 1, idx)
    return torch.where(valid, partner, -1), valid


def all_pairs_candidates(n: int, device):
    """O(N^2) candidate matrix for small scenes and parity tests."""
    return torch.arange(n, dtype=torch.int32,
                        device=device)[None, :].expand(n, n)


class FatGrid(NamedTuple):
    """Cell table whose bucket rows carry ``[x*cap | y*cap | z*cap |
    idx*cap]`` (idx stored as ``index + 0.5``, -1 for empty) and the
    occupants' max bound radius ``r_max``."""
    table: torch.Tensor     # (ncell, cap * 4) float32
    overflow: torch.Tensor  # () int32
    width: int = 4
    r_max: torch.Tensor = None


def build_fat_grid(bounds: AABB, cfg: GridConfig, width: int = 4,
                   valid=None) -> FatGrid:
    """Bin bodies with their conservative bound radius into the grid.
    ``valid`` (N,) bool keeps dead rows out of the table entirely."""
    if width != 4:
        raise NotImplementedError(
            "build_fat_grid(width=8) serves the fat/fat8 broadphase modes "
            "(ROADMAP slice 14)")
    centers = bounds.c
    ncell = grid_ncells(cfg)
    cap = cfg.bucket_cap
    r_eff = torch.maximum(bounds.r.x, torch.maximum(bounds.r.y, bounds.r.z))
    if valid is not None:
        r_eff = torch.where(valid, r_eff, 0.0)
    order, sorted_h, rank = _binned(centers, cfg, valid)
    in_table = sorted_h < ncell
    ok = (rank < cap) & in_table
    n_over = torch.sum((rank >= cap) & in_table).to(torch.int32)
    rows4 = torch.stack([centers.x[order], centers.y[order],
                         centers.z[order],
                         order.to(torch.float32) + 0.5], dim=-1)
    # one extra sentinel slot takes the rows JAX drops (mode='drop')
    table4 = torch.tensor([0.0, 0.0, 0.0, -1.0], dtype=torch.float32,
                          device=sorted_h.device).repeat(ncell * cap + 1, 1)
    slot = sorted_h * cap + torch.clamp(rank, max=cap - 1)
    table4[torch.where(ok, slot, ncell * cap).long()] = rows4
    table = (table4[:ncell * cap].reshape(ncell, cap, 4)
             .transpose(1, 2).reshape(ncell, 4 * cap))
    return FatGrid(table=table, overflow=n_over, width=4,
                   r_max=torch.max(r_eff))


def fat_grid_pairs(bounds: AABB, grid: FatGrid, cfg: GridConfig,
                   max_pairs: int, ordered: bool = True, window: str = "27"):
    """Candidate partners per body straight from the fat grid: 27
    bucket-row gathers -> AABB cull -> top-``max_pairs`` by the fused
    (quantized distance | index) int32 key.  Returns (partner
    (N, max_pairs) int32, valid)."""
    if window != "27" or grid.width != 4:
        raise NotImplementedError(
            "only the 27-cell window over width-4 rows (fat27x4) is on the "
            "flagship path; sel8 and width-8 are ROADMAP slice 14")
    centers = bounds.c
    n_bodies = centers.x.shape[0]
    if n_bodies > (1 << 17):
        raise NotImplementedError(
            "the float-score top-k past 2^17 bodies is ROADMAP slice 14")
    self_rows = torch.arange(n_bodies, dtype=torch.int32,
                             device=centers.x.device)
    cx, cy, cz = _cell_coords(centers, cfg)
    sx, sy, sz = centers.x, centers.y, centers.z
    sr = torch.maximum(bounds.r.x, torch.maximum(bounds.r.y, bounds.r.z))
    d2_max = (3.0 * cfg.cell_size) ** 2
    inv_scale = 16383.0 / d2_max
    cap = cfg.bucket_cap
    rr = grid.r_max + sr[:, None]
    keys = []
    for (dx, dy, dz) in _OFFSETS:
        h = _bucket_index(cx + dx, cy + dy, cz + dz, cfg)
        bucket = grid.table[h.long()]            # (N, cap*4) ONE gather
        bx = bucket[:, 0:cap]
        by = bucket[:, cap:2 * cap]
        bz = bucket[:, 2 * cap:3 * cap]
        raw_idx = bucket[:, 3 * cap:4 * cap]
        idx = raw_idx.to(torch.int32)            # truncates index + 0.5
        ddx = bx - sx[:, None]
        ddy = by - sy[:, None]
        ddz = bz - sz[:, None]
        ok = ((raw_idx >= 0.0) & (torch.abs(ddx) <= rr)
              & (torch.abs(ddy) <= rr) & (torch.abs(ddz) <= rr))
        if ordered:
            ok = ok & (idx < self_rows[:, None])
        else:
            ok = ok & (idx != self_rows[:, None])
        d2 = ddx * ddx + ddy * ddy + ddz * ddz
        q = torch.clamp((d2 * inv_scale).to(torch.int32), max=16383)
        keys.append(torch.where(ok, ((16383 - q) << 17) | idx, -1))
    keym = torch.cat(keys, dim=1)                # (N, 27*cap) int32
    if keym.shape[1] <= max_pairs:
        top = torch.nn.functional.pad(
            keym, (0, max_pairs - keym.shape[1]), value=-1)
    else:
        # keys are unique per candidate (or identical duplicates of one
        # candidate), so the top-k VALUES do not depend on tie order
        top = torch.topk(keym, max_pairs, dim=1).values
    valid = top >= 0
    return torch.where(valid, top & 0x1FFFF, -1), valid


def swept_fat_bounds(bounds: AABB, delta: Vec3, fatten: float = 0.0) -> AABB:
    """Swept (combine start/end) + optionally fattened AABB
    (bounds.rs:60-68 + world.rs:181 ``bounds + 0.25``)."""
    lo = vmin(bounds.c - bounds.r, bounds.c + delta - bounds.r)
    hi = vmax(bounds.c + bounds.r, bounds.c + delta + bounds.r)
    c = (hi + lo) * 0.5
    r = (hi - lo) * 0.5
    return AABB(c=c, r=Vec3(r.x + fatten, r.y + fatten, r.z + fatten))

"""Cell-grid broadphase (counterpart of ``mgf_tpu.broadphase``).

**packed** (the generic branch): :func:`build_grid` bins body indices into
a ``(ncell, bucket_cap)`` table; :func:`neighbor_candidates` gathers the
27 neighbour buckets of every body; :func:`refine_pairs` culls them by
swept-AABB overlap and keeps the ``max_pairs`` closest.  ``lax.top_k``
keeps the lower index among equal scores, and an unjittered lattice has
many equal distances, so the selection is a stable descending sort.

**fat grids** (the ``"fat"``, ``"fat8"``, ``"fat8x4"`` and ``"fat27x4"``
broadphase modes): bodies are binned by swept-AABB center into cells of
side ``cell_size``, addressed modulo power-of-two grid dimensions: a
dense ``(ncell, bucket_cap * width)`` float table whose bucket rows carry
the occupants' bounds and indices inline (width 8: per slot ``[cx cy cz
r_eff idx 0 0 0]``; width 4: component-blocked ``[x*cap | y*cap | z*cap
| idx*cap]``).  Building it is a stable sort + rank + scatter;
candidates for a body are the bucket rows of its 27 neighbour cells (or
of the 2x2x2 octant ``"sel8"``), culled by an AABB test and ranked by a
fused int32 key (14-bit quantized distance | 17-bit body index), or past
2^17 bodies by a float score.

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


def refine_pairs(bounds: AABB, cand, max_pairs: int, self_rows=None,
                 ordered: bool = True, packed=None):
    """Cull candidates by swept-AABB overlap; keep the closest
    ``max_pairs`` per body.  ``cand`` is the (rows, K) candidate matrix of
    global body indices and ``self_rows`` the global index of each
    candidate row (by default 0..rows-1); ``ordered`` keeps only partners
    of smaller index (the reference's dedupe), ``ordered=False`` both
    directions.  ``packed`` is :func:`pack_bounds` of ``bounds`` when the
    caller has it.  Returns (partner (rows, max_pairs) int32, valid)."""
    if self_rows is None:
        self_rows = torch.arange(cand.shape[0], dtype=torch.int32,
                                 device=cand.device)
    if packed is None:
        packed = pack_bounds(bounds)
    gb = packed[torch.clamp(cand, min=0).long()]     # (rows, K, 4): ONE gather
    sb = packed[self_rows.long()][:, None, :]        # (rows, 1, 4)
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
    """Cell table whose bucket rows carry the occupants' bounds inline, so
    the candidate cull needs no per-candidate gather.  ``width == 8``: per
    slot ``[cx cy cz r_eff idx 0 0 0]``; ``width == 4``: component-blocked
    ``[x*cap | y*cap | z*cap | idx*cap]`` with the occupants' max bound
    radius in ``r_max`` (half the bytes; the cull is then conservative for
    mixed radii).  ``idx`` is stored as ``index + 0.5``, -1 for empty."""
    table: torch.Tensor     # (ncell, cap * width) float32
    overflow: torch.Tensor  # () int32
    width: int = 8
    r_max: torch.Tensor = None


def build_fat_grid(bounds: AABB, cfg: GridConfig, width: int = 8,
                   valid=None) -> FatGrid:
    """Bin bodies with their conservative bound radius into the grid.
    ``valid`` (N,) bool keeps dead rows out of the table entirely."""
    if width not in (4, 8):
        raise ValueError(f"fat grid width must be 4 or 8, got {width}")
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
    idx = order.to(torch.float32) + 0.5
    if width == 4:
        rows = torch.stack([centers.x[order], centers.y[order],
                            centers.z[order], idx], dim=-1)
    else:
        z = torch.zeros_like(idx)
        rows = torch.stack([centers.x[order], centers.y[order],
                            centers.z[order], r_eff[order], idx, z, z, z],
                           dim=-1)
    # an empty row is all zeros with index -1 (column 3 of 4, 4 of 8); one
    # extra sentinel slot takes the rows JAX drops (mode='drop')
    table = torch.zeros((ncell * cap + 1, width), dtype=torch.float32,
                        device=sorted_h.device)
    table[:, 3 if width == 4 else 4].fill_(-1.0)
    slot = sorted_h * cap + torch.clamp(rank, max=cap - 1)
    table[torch.where(ok, slot, ncell * cap).long()] = rows
    table = table[:ncell * cap].reshape(ncell, cap, width)
    if width == 4:
        # component-blocked: each component's cap slots lane-contiguous
        table = table.transpose(1, 2)
    return FatGrid(table=table.reshape(ncell, width * cap), overflow=n_over,
                   width=width, r_max=torch.max(r_eff))


def _top_pairs(cand, score, max_pairs: int):
    """The ``max_pairs`` best candidates by float score (the path past 2^17
    bodies, where the fused int key's 17-bit index no longer fits).
    ``lax.top_k`` keeps the lower column among equal scores: a stable
    descending sort."""
    if cand.shape[1] <= max_pairs:
        partner = torch.nn.functional.pad(
            cand, (0, max_pairs - cand.shape[1]), value=-1)
        return partner, partner >= 0
    top, pick = torch.sort(score, dim=1, descending=True, stable=True)
    top, pick = top[:, :max_pairs], pick[:, :max_pairs]
    valid = torch.isfinite(top)
    return torch.where(valid, torch.gather(cand, 1, pick), -1), valid


def fat_grid_pairs(bounds: AABB, grid: FatGrid, cfg: GridConfig,
                   max_pairs: int, self_rows=None, ordered: bool = True,
                   query_centers: Vec3 = None, window: str = "27"):
    """Candidate partners per body straight from the fat grid: bucket-row
    gathers -> AABB cull -> the ``max_pairs`` closest.  Returns (partner
    (rows, max_pairs) int32, valid).

    ``query_centers`` (default ``bounds.c``) pick the cells a row queries
    and ``self_rows`` (default 0..rows-1) its global body index, so a
    shard can query its own rows against a global table.  ``window``:

    * ``"27"``: the 3x3x3 block, pair reach up to ``cell_size``;
    * ``"sel8"``: the 2x2x2 octant nearest the query point (per axis the
      own cell and the neighbour on the side the point lies in), pair
      reach guaranteed only up to ``cell_size / 2``.

    Width-8 rows cull with each occupant's own radius, width-4 rows with
    the table's ``r_max``.  Up to 2^17 bodies the score is a fused int32
    key (14-bit quantized distance | 17-bit index), past it a float score
    and a separate index."""
    centers = query_centers if query_centers is not None else bounds.c
    dev = centers.x.device
    if self_rows is None:
        self_rows = torch.arange(centers.x.shape[0], dtype=torch.int32,
                                 device=dev)
    cx, cy, cz = _cell_coords(centers, cfg)
    rows_l = self_rows.long()
    sx, sy, sz = (c[rows_l] for c in bounds.c)
    sr = torch.maximum(bounds.r.x, torch.maximum(bounds.r.y,
                                                 bounds.r.z))[rows_l]
    if window == "sel8":
        # which half of its cell is the point in, per axis?
        half = lambda p, c: torch.where(
            p - c.to(p.dtype) * cfg.cell_size > 0.5 * cfg.cell_size, 1, -1
        ).to(torch.int32)
        so = (half(centers.x, cx), half(centers.y, cy), half(centers.z, cz))
        offsets = [(ax, ay, az) for ax in (0, 1) for ay in (0, 1)
                   for az in (0, 1)]
        cells = lambda o: (cx + so[0] * o[0], cy + so[1] * o[1],
                           cz + so[2] * o[2])
    else:
        offsets = _OFFSETS
        cells = lambda o: (cx + o[0], cy + o[1], cz + o[2])
    width = grid.width
    cap = cfg.bucket_cap
    use_ikey = bounds.c.x.shape[0] <= (1 << 17)
    inv_scale = 16383.0 / (3.0 * cfg.cell_size) ** 2
    keys, cands, scores = [], [], []
    for o in offsets:
        bucket = grid.table[_bucket_index(*cells(o), cfg).long()]  # ONE gather
        if width == 4:
            bx = bucket[:, 0:cap]
            by = bucket[:, cap:2 * cap]
            bz = bucket[:, 2 * cap:3 * cap]
            raw_idx = bucket[:, 3 * cap:4 * cap]
            rr = grid.r_max + sr[:, None]
        else:
            b8 = bucket.reshape(-1, cap, 8)
            bx, by, bz = b8[..., 0], b8[..., 1], b8[..., 2]
            raw_idx = b8[..., 4]
            rr = b8[..., 3] + sr[:, None]
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
        if use_ikey:
            q = torch.clamp((d2 * inv_scale).to(torch.int32), max=16383)
            keys.append(torch.where(ok, ((16383 - q) << 17) | idx, -1))
        else:
            cands.append(torch.where(ok, idx, -1))
            scores.append(torch.where(ok, -d2, -float("inf")))
    # columns offset-major, slot-minor, as the JAX package lays them out
    if not use_ikey:
        return _top_pairs(torch.cat(cands, dim=1), torch.cat(scores, dim=1),
                          max_pairs)
    keym = torch.cat(keys, dim=1)                # (rows, W) int32
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

"""Spatially sharded physics step: slab decomposition + halo exchange
(counterpart of ``mgf_tpu.parallel.spatial``).

The all-gather design in :mod:`mgf_tpu_torch.parallel.sharded` replicates
the whole world on every rank.  This module is the scalable design:

* bodies are assigned to ranks by x-slab (a host-side sort at shard time,
  :func:`shard_world_spatial`), so a body's broadphase partners live on the
  same rank or an adjacent one;
* each step, every rank selects its H bodies nearest each slab edge (the
  *halo*) and sends their 16-float shape rows to that neighbour, one
  message per direction;
* the grid, broadphase, narrowphase, terrain cull and constraint assembly
  run on the rank's own rows + 2H halo rows (a local index space);
* each solver outer iteration re-exchanges only the halo rows' packed
  velocity state ((8, H) per direction), so the twin constraint copies on
  both owners see fresh partner velocities.

Comm per step (``metrics["comm_floats_per_step"]``, the JAX package's
formula): 2 x (H x 16 floats) [+ 2H counts] + iters x 2 x (H x 8 floats)
per rank.  The JAX package sends each field of the constraint build's body
view with its own ``ppermute``; here one direction's fields travel as one
(H, 21) message (with the counts, (H, 22)): the same values in fewer round
trips.  The formula does not count that body view, as in the JAX package;
``comm.BYTES`` counts what really moved.

The flagship stress config runs on this path: warm starting (rows keyed
by GLOBAL body ids carried inside the halo rows), the "near" / "grid"
terrain culls, the fat8x4 / fat27x4 broadphase, stable candidate slots,
the ``bp_every`` cache (per-rank anchors and slack, the rebuild decision
``pmax``'d so every rank rebuilds in lockstep), hybrid warm matching and
the adaptive schedule (on the ``psum``'d warm-hit fraction).  The JAX step
switches with ``lax.cond`` in three places; here each is a host read of
the ALL-REDUCED value, so every rank takes the same branch and issues the
same sequence of messages.

Soundness: a pair is found iff both bodies are within ``halo_width`` of
the shared slab boundary and within the top-H nearest.  Drift beyond halo
reach of the home slab is counted in ``metrics["spatial_stray"]``: gather
the world (:func:`mgf_tpu_torch.parallel.gather_world`) and call
:func:`shard_world_spatial` again when it goes above 0.  Config fields this
path cannot honor raise or warn.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from mgf_tpu_torch import broadphase
from mgf_tpu_torch.collision import LocalContact
from mgf_tpu_torch.geom import AABB
from mgf_tpu_torch.manifold import prune
from mgf_tpu_torch.math3d import (
    Mat3, Vec3, cross, magnitude2, mat_vec, tree_map, vmax, vmin,
)
from mgf_tpu_torch.ops.terrain import (
    gather_triangles, near_terrain, sphere_terrain_near,
)
from mgf_tpu_torch.parallel.sharded import pad_bodies, rank_rows, replicated
from mgf_tpu_torch.physics import complete_motion, integrate
from mgf_tpu_torch.solver import (
    BodyView, _friction_impulses, _normal_impulse, build_row_constraints,
    pack_body_state, unpack_body_state,
)
from mgf_tpu_torch.world import (
    PackedShapes, SolverWarm, World, WorldConfig, _compact_rows, _deepest,
    _grid_terrain, _isum, _man_to_rows, _match_warm, _one_pass_terrain,
    _pair_contact, _terrain_contact, _top_terrain_rows, gather_shapes,
    manifold_prox_sq, pack_shapes, self_shapes, shape_view, solver_row_count,
)


def shard_world_spatial(world: World, comm, cfg: WorldConfig = None):
    """Sort the bodies by x on the host, pad them to a multiple of the rank
    count, and return ``(this rank's slab, boundaries)``: boundaries is the
    (D+1,) float32 array of slab x-extents that :func:`make_spatial_step`
    takes.  Every rank calls it with the same whole world.

    With ``cfg.warm_start`` the shard gets a zeroed (R, n_loc) warm state;
    re-sharding resets it (warm keys are global sorted-order ids, which a
    re-shard permutes), so the frame after a re-shard solves cold."""
    d = comm.size
    xs = world.bodies.x.x.detach().cpu().numpy()
    order = np.argsort(xs, kind="stable")
    take = torch.as_tensor(order)
    bodies = tree_map(lambda g: g.detach().cpu()[take], world.bodies)
    bodies = pad_bodies(bodies, d)
    n_loc = bodies.n_bodies // d
    xs_sorted = np.concatenate(
        [np.sort(xs), np.full(bodies.n_bodies - len(xs), np.inf)])
    bounds = np.empty(d + 1, np.float32)
    bounds[0] = -np.inf
    bounds[d] = np.inf
    for k in range(1, d):
        lo = xs_sorted[k * n_loc - 1]
        hi = xs_sorted[k * n_loc] if k * n_loc < len(xs) else lo
        bounds[k] = 0.5 * (lo + min(hi, lo + 1.0))
    warm = None
    if cfg is not None and cfg.warm_start:
        R = solver_row_count(cfg, world.terrain.a.x.shape[0])
        z = lambda: torch.zeros((R, n_loc), dtype=torch.float32,
                                device=comm.device)
        none = lambda: torch.full((R, n_loc), -9, dtype=torch.int32,
                                  device=comm.device)
        warm = SolverWarm(partner=none(), key2=none(), acc_n=z(), acc_t1=z(),
                          acc_t2=z())
    return (World(bodies=rank_rows(bodies, comm.rank, n_loc, comm.device),
                  warm=warm, **replicated(world, comm.device)),
            bounds)


class SpatialBpCache(NamedTuple):
    """One rank's broadphase cache for the ``cfg.bp_every`` cadence on the
    spatial path (the multi-device analog of ``world.BpCache``).

    * candidate lists are LOCAL-index (own rows 0..n_loc-1, halo slots
      n_loc..n_loc+2H-1), valid across steps because the HALO MEMBERSHIP
      (the sl / sr index lists) is cached too;
    * the rebuild trigger is the single-device one (drift + reach growth
      against per-body build slack) ``pmax``'d across the ranks."""
    partner: torch.Tensor   # (n_loc, K) int32 local candidate indices
    ok: torch.Tensor        # (n_loc, K) bool
    anchor: Vec3            # (n_loc,) build positions (end-of-sweep)
    slack: torch.Tensor     # (n_loc,) float32 per-body build slack
    r_build: torch.Tensor   # (n_loc,) float32 swept fat radius at build
    overflow: torch.Tensor  # (1,) int32 grid overflow at build
    count: torch.Tensor     # (1,) int32 steps since init
    sl_idx: torch.Tensor    # (H,) int32 send-left membership at build
    sl_ok: torch.Tensor     # (H,) bool
    sr_idx: torch.Tensor    # (H,) int32 send-right membership at build
    sr_ok: torch.Tensor     # (H,) bool


def init_spatial_bp_cache(world: World, comm, cfg: WorldConfig,
                          halo: int) -> World:
    """Attach an (invalid) spatial broadphase cache to this rank's shard;
    the first step rebuilds.  ``halo`` must match the value passed to
    :func:`make_spatial_step`."""
    n_loc = world.bodies.n_bodies
    H = min(int(halo), n_loc)
    dev = comm.device
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=dev)
    far = lambda: torch.full((n_loc,), 1.0e9, dtype=torch.float32,
                             device=dev)
    return world._replace(bp=SpatialBpCache(
        partner=torch.full((n_loc, cfg.max_pairs), -1, dtype=torch.int32,
                           device=dev),
        ok=z((n_loc, cfg.max_pairs), torch.bool),
        anchor=Vec3(far(), far(), far()),
        slack=z((n_loc,), torch.float32),
        r_build=z((n_loc,), torch.float32),
        overflow=z((1,), torch.int32), count=z((1,), torch.int32),
        sl_idx=z((H,), torch.int32), sl_ok=z((H,), torch.bool),
        sr_idx=z((H,), torch.int32), sr_ok=z((H,), torch.bool)))


# Every WorldConfig field is either HONORED by the spatial step (the
# single-device semantics) or FLAGGED in _check_cfg (raises or warns the
# moment a config requests it): the JAX package's registry, unchanged.
HONORED_FIELDS = frozenset({
    "dt", "solver_iters", "grid", "max_pairs", "fatten", "shape_mode",
    "friction_mode", "two_phase", "solver_inner", "broadphase",
    "terrain_rows", "terrain_bp", "terrain_cand", "terrain_grid_cfg",
    "warm_start", "solver_rows", "cap_manifold", "stable_pairs",
    "warm_gamma",        # scales the matched warm transfer at match time
    "warm_match",        # hybrid/pos honored with a bp cache (exact on
                         # reuse steps); upgraded-with-warning otherwise
    "adapt_schedule",    # on the psum'd warm-hit fraction (every rank
                         # takes the same branch)
    "bp_every",          # per-rank anchors/slack + a pmax'd rebuild flag
    "bias_max",          # threaded into build_row_constraints unchanged
    "light_metrics",     # skips the same observability metrics
    "fused_iso",         # SEMANTICS honored (previous-frame mass-splitting
                         # counts ride the halo rows)
})
FLAGGED_FIELDS = frozenset({
    "profile_stage", "solver", "bp_margin", "pallas_narrowphase",
    "pallas_solver", "n_sphere_rows", "use_grid",
})


def _check_cfg(cfg: WorldConfig):
    """Reject or warn on config fields the spatial path does not honor
    (never silently diverge from the requested semantics)."""
    if cfg.profile_stage:
        raise ValueError("spatial step has no profile_stage hooks")
    if cfg.solver != "rows":
        raise ValueError("spatial step implements the rows solver only")
    if not cfg.use_grid:
        warnings.warn(
            "spatial step always uses the local fat-grid broadphase; "
            "cfg.use_grid=False (all-pairs candidates) is ignored",
            stacklevel=3)
    if cfg.bp_margin > 0.0:
        warnings.warn(
            "spatial step supports the cfg.bp_every staleness-gated "
            "cadence but not the bp_margin fat-proxy variant; bp_margin "
            "is ignored", stacklevel=3)
    if cfg.pallas_narrowphase:
        warnings.warn(
            "spatial step uses the plain narrowphase; "
            "cfg.pallas_narrowphase is ignored (identical contacts)",
            stacklevel=3)
    if cfg.pallas_solver:
        warnings.warn(
            "spatial step runs its solve as the plain halo-exchange sweep; "
            "cfg.pallas_solver is ignored (the kernel implements the "
            "single-device iso row layout; identical math either way)",
            stacklevel=3)
    if cfg.n_sphere_rows >= 0:
        warnings.warn(
            "spatial sharding re-sorts bodies by x, breaking the "
            "type-partitioned layout cfg.n_sphere_rows describes; the "
            "generic 4-kernel mixed narrowphase runs instead (identical "
            "contacts)", stacklevel=3)
    if (cfg.warm_start and cfg.warm_match in ("pos", "hybrid")
            and not (cfg.bp_every > 1 and cfg.stable_pairs)):
        warnings.warn(
            "spatial warm_match='pos'/'hybrid' needs the bp cache "
            "(cfg.bp_every > 1) + stable_pairs to make slots stable "
            "across frames; upgraded to the order-robust search matching",
            stacklevel=3)


def _swept_bounds(cfg: WorldConfig, centers: Vec3, delta: Vec3, r_shape):
    """Swept, fattened bounds of a sphere of radius ``r_shape`` (the
    capsule's radius plus half height: the step's own conservative box)."""
    rv = Vec3(r_shape, r_shape, r_shape)
    blo = vmin(centers - rv, centers + delta - rv)
    bhi = vmax(centers + rv, centers + delta + rv)
    c = (bhi + blo) * 0.5
    rr = (bhi - blo) * 0.5
    f = cfg.fatten
    return AABB(c=c, r=Vec3(rr.x + f, rr.y + f, rr.z + f))


def _sorted_pairs(partner, pair_ok):
    """Canonical slot order and duplicate masking, invalid slots 0 (the
    spatial step's own form of ``stable_pairs``)."""
    big = 1 << 28
    p_s = torch.sort(torch.where(pair_ok, partner, big), dim=1).values
    dup = torch.zeros_like(pair_ok)
    dup[:, 1:] = p_s[:, 1:] == p_s[:, :-1]
    ok = (p_s < big) & ~dup
    return torch.where(ok, p_s, 0), ok


def _body_fields(state, x_end):
    """The constraint build's per-body fields as (n, 21) columns: x_end,
    v, omega, restitution, friction, inv_mass, inv_moment (row-major)."""
    return torch.stack([*x_end, *state.v, *state.omega, state.restitution,
                        state.friction, state.inv_mass, *state.inv_moment],
                       dim=-1)


def make_spatial_step(cfg: WorldConfig, comm, boundaries, halo: int = 256,
                      halo_width: float = None):
    """The halo-exchange step of one rank: ``step_fn(world) -> (world,
    metrics)`` on this rank's shard; every rank calls it once a step.  The
    metrics are reduced over the ranks (the same values on every rank).

    ``boundaries``: (D+1,) slab x-extents from :func:`shard_world_spatial`.
    ``halo``: fixed halo row capacity per direction.
    ``halo_width``: pair reach the halo must cover; defaults to the grid
    cell size (the candidate window guarantee)."""
    _check_cfg(cfg)
    D, rank = comm.size, comm.axis_index()
    boundaries = np.asarray(boundaries, np.float32)
    if halo_width is None:
        halo_width = cfg.grid.cell_size
    bp_width = 4 if cfg.broadphase in ("fat8x4", "fat27x4") else 8
    bp_window = "sel8" if cfg.broadphase in ("fat8", "fat8x4") else "27"
    use_warm = cfg.warm_start
    use_cache = cfg.bp_every > 1
    light = cfg.light_metrics
    n_slots = 1 if cfg.shape_mode == "spheres" else 2
    prox = manifold_prox_sq(cfg)
    guarantee = cfg.grid.cell_size * (0.5 if bp_window == "sel8" else 1.0)
    slab = lambda k: torch.tensor(boundaries[k], device=comm.device)
    lo, hi = slab(rank), slab(rank + 1)        # this rank's x-extent

    def step_fn(world: World):
        if use_warm and world.warm is None:
            raise ValueError(
                "cfg.warm_start needs world.warm — shard with "
                "shard_world_spatial(world, comm, cfg=cfg)")
        if use_cache and world.bp is None:
            raise ValueError(
                "cfg.bp_every > 1 needs world.bp — attach with "
                "init_spatial_bp_cache(world, comm, cfg, halo)")
        state = complete_motion(world.bodies)
        state = integrate(state, cfg.dt)
        n_loc = state.n_bodies
        H = min(int(halo), n_loc)        # halo can't exceed the shard
        dev = state.inv_mass.device
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
        i32 = lambda n: torch.arange(n, dtype=torch.int32, device=dev)
        terrain = world.terrain
        n_tris = terrain.a.x.shape[0]
        gid_own = rank * n_loc + i32(n_loc)
        gid_static = D * n_loc            # global id of the terrain row
        alive_own = state.shape_r > 0.0   # pads carry shape_r = -1
        bp_in, warm_in = world.bp, world.warm

        # ---- bp cache staleness: the single-device trigger, pmax'd ----
        r_shape_own = state.shape_r + torch.where(
            state.shape_type == 1, state.shape_half_h, 0.0)
        bounds_own = _swept_bounds(cfg, state.x, state.delta, r_shape_own)
        r_eff_own = torch.where(alive_own, torch.maximum(
            bounds_own.r.x, torch.maximum(bounds_own.r.y, bounds_own.r.z)),
            0.0)
        x_end = state.x + state.delta
        if use_cache:
            drift = torch.sqrt(magnitude2(x_end - bp_in.anchor))
            dmag = torch.sqrt(magnitude2(state.delta))
            desired = (cfg.bp_every - 1) * (2.0 * dmag + 0.02)
            budget = torch.clamp(0.5 * guarantee - r_eff_own, min=0.0)
            slack_new = torch.minimum(desired, budget)
            r_grow = torch.clamp(r_eff_own - bp_in.r_build, min=0.0)
            stale = torch.max(torch.where(
                alive_own, drift + r_grow - bp_in.slack, 0.0)) > 0.0
            need = ((bp_in.count[0] % cfg.bp_every) == 0) | stale
            # the lockstep decision: every rank reads the same max
            need = bool(comm.pmax(need.to(torch.int32).reshape(1))[0])
        else:
            slack_new = torch.zeros((n_loc,), dtype=torch.float32,
                                    device=dev)
            need = True

        # ---- halo selection: H bodies nearest each slab edge ----
        # (lax.top_k keeps the lower index on ties: stable sorts)
        x = state.x.x
        band = halo_width + slack_new
        sl_idx_f = torch.sort(-x, descending=True, stable=True).indices[:H]
        sl_ok_f = (x[sl_idx_f] <= lo + band[sl_idx_f]) & alive_own[sl_idx_f]
        sr_idx_f = torch.sort(x, descending=True, stable=True).indices[:H]
        sr_ok_f = (x[sr_idx_f] >= hi - band[sr_idx_f]) & alive_own[sr_idx_f]
        sl_idx_f, sr_idx_f = sl_idx_f.to(torch.int32), sr_idx_f.to(torch.int32)
        if use_cache and not need:
            sl_idx, sl_ok = bp_in.sl_idx, bp_in.sl_ok
            sr_idx, sr_ok = bp_in.sr_idx, bp_in.sr_ok
        else:
            sl_idx, sl_ok, sr_idx, sr_ok = sl_idx_f, sl_ok_f, sr_idx_f, sr_ok_f
        sl_l, sr_l = sl_idx.long(), sr_idx.long()
        halo_overflow = (
            _isum((x <= lo + band) & alive_own) - _isum(sl_ok_f)
            + _isum((x >= hi - band) & alive_own) - _isum(sr_ok_f))
        stray = _isum(((x < lo - halo_width) | (x > hi + halo_width))
                      & alive_own)

        # previous-frame contact counts (fused_iso mass-splitting
        # semantics), exchanged WITH the halo shape rows
        cnt_iso = use_warm and cfg.fused_iso
        if cnt_iso:
            cnt_prev = torch.clamp(torch.sum(
                (warm_in.partner != -9).to(torch.float32), dim=0), min=1.0)
        else:
            cnt_prev = torch.ones((n_loc,), dtype=torch.float32, device=dev)

        # ---- pack + exchange halo rows (16 floats per body) ----
        # layout: x y z dx dy dz r half_h qw qx qy qz stype | global id |
        #         cnt_prev | build slack
        ps_own = pack_shapes(shape_view(state), "mixed")       # 13 columns
        far = 1.0e8 + torch.arange(H, dtype=torch.float32,
                                   device=dev)[:, None] * 100.0

        def pack_halo(idx, ok):
            okc = ok[:, None]
            p13 = torch.where(okc, ps_own.p8[idx], 0.0)
            # park invalid halo rows far away with NEGATIVE radius: the
            # grid build masks r <= 0 rows out entirely
            p13 = torch.where(okc, p13, torch.cat([far, far, far,
                                                   p13[:, 3:]], dim=1))
            p13[:, 6] = torch.where(ok, p13[:, 6], -1.0e3)
            p13[:, 8] = torch.where(ok, p13[:, 8], 1.0)          # qw
            gid = torch.where(ok, gid_own[idx], -7)
            cnt = torch.where(ok, cnt_prev[idx], 1.0)
            slk = torch.where(ok, slack_new[idx], 0.0)
            return torch.cat([p13, gid[:, None].to(torch.float32),
                              cnt[:, None], slk[:, None]], dim=1)  # (H, 16)

        # rows sent LEFT become the left neighbour's right halo; an edge
        # rank receives zeros (rank 0's left halo, rank D-1's right halo)
        recv_l, recv_r = comm.exchange(pack_halo(sl_l, sl_ok),
                                       pack_halo(sr_l, sr_ok))
        lp13, rp13 = recv_l[:, :13], recv_r[:, :13]
        ps = PackedShapes(
            p8=torch.cat([ps_own.p8, lp13, rp13], dim=0),
            shape_type=torch.cat([state.shape_type,
                                  lp13[:, 12].to(torch.int32),
                                  rp13[:, 12].to(torch.int32)]))
        gids = torch.cat([gid_own, recv_l[:, 13].to(torch.int32),
                          recv_r[:, 13].to(torch.int32),
                          torch.full((1,), gid_static, dtype=torch.int32,
                                     device=dev)])
        m_rows = n_loc + 2 * H          # local body-table height
        alive_all = ps.p8[:, 6] > 0.0   # own pads + parked / edge rows out

        # ---- local grid over own + halo rows (cached across steps) ----
        p8 = ps.p8
        r_shape_all = p8[:, 6] + torch.where(ps.shape_type == 1, p8[:, 7],
                                             0.0)
        bounds = _swept_bounds(cfg, Vec3(p8[:, 0], p8[:, 1], p8[:, 2]),
                               Vec3(p8[:, 3], p8[:, 4], p8[:, 5]),
                               r_shape_all)
        own_rows = i32(n_loc)
        bp_drift_excess = f32(0.0)
        if need:
            # build bounds inflated by per-body slack (own rows: this
            # step's; halo rows: their owner's, from the halo row)
            slack_all = torch.cat([slack_new, recv_l[:, 15], recv_r[:, 15]])
            bb = bounds._replace(r=Vec3(*(c + slack_all for c in bounds.r)))
            grid = broadphase.build_fat_grid(bb, cfg.grid, width=bp_width,
                                             valid=alive_all)
            partner, pair_ok = broadphase.fat_grid_pairs(
                bb, grid, cfg.grid, cfg.max_pairs, self_rows=own_rows,
                ordered=False,
                query_centers=tree_map(lambda g: g[:n_loc], bounds.c),
                window=bp_window)
            if cfg.stable_pairs:
                partner, pair_ok = _sorted_pairs(partner, pair_ok)
            overflow = grid.overflow
            anchor, bslack, rbuild = x_end, slack_new, r_eff_own
        else:
            partner, pair_ok = bp_in.partner, bp_in.ok
            overflow = bp_in.overflow[0]
            anchor, bslack, rbuild = bp_in.anchor, bp_in.slack, bp_in.r_build
            bp_drift_excess = torch.clamp(torch.max(torch.where(
                alive_own, drift - bslack, 0.0)), min=0.0)
        bp_out = world.bp
        if use_cache:
            bp_out = SpatialBpCache(
                partner=partner, ok=pair_ok, anchor=anchor, slack=bslack,
                r_build=rbuild, overflow=overflow.reshape(1),
                count=bp_in.count + 1, sl_idx=sl_idx, sl_ok=sl_ok,
                sr_idx=sr_idx, sr_ok=sr_ok)

        # ---- narrowphase over own candidate rows, slot-major (K, n) ----
        K = partner.shape[1]
        partner_t, pair_ok_t = partner.T, pair_ok.T
        ga = self_shapes(cfg, shape_view(state))           # (1, n) self
        gb = gather_shapes(cfg, ps, torch.where(pair_ok_t, partner_t, 0))
        pc = _pair_contact(cfg, ga, gb)
        pc = pc._replace(valid=pc.valid & pair_ok_t[None])
        lc = LocalContact(local_a=pc.a - (ga.x + ga.delta * pc.t),
                          local_b=pc.b - (gb.x + gb.delta * pc.t),
                          contact=pc)
        pair_manifold = prune(lc, max_contacts=n_slots, prox_sq=prox)
        max_pen = _deepest(pc)
        S_pair = pair_manifold.valid.shape[0]
        blocks = [_man_to_rows(pair_manifold, K, n_loc)]
        partners = [torch.where(pair_ok_t, partner_t, m_rows)[None].expand(
            S_pair, K, n_loc).reshape(-1, n_loc)]
        # warm keys: pair rows by (partner GLOBAL id, manifold slot),
        # terrain rows by (static id, triangle id)
        key2s = [i32(S_pair)[:, None, None].expand(S_pair, K, n_loc)
                 .reshape(-1, n_loc)]

        # ---- terrain narrowphase: one pass for spheres against a small
        # mesh (kernel K5), else dense | near | grid cull ----
        t_reach_excess = f32(0.0)
        if n_tris > 0:
            if _one_pass_terrain(cfg, n_tris, False):
                t_width = cfg.terrain_cand
                t_man, t_tris, t_deep = sphere_terrain_near(
                    state.x, state.delta, state.shape_r, state.shape_half_h,
                    terrain, world.terrain_center, t_width, cfg.stable_pairs)
            else:
                if cfg.terrain_bp == "near":
                    t_cand, t_ok = near_terrain(
                        terrain, state.x, state.delta, state.shape_r,
                        state.shape_half_h, cfg.terrain_cand)
                    t_width = cfg.terrain_cand
                elif cfg.terrain_bp == "grid":
                    t_cand, t_ok, _ = _grid_terrain(world, state, cfg)
                    t_width = cfg.terrain_cand
                    t_reach = (state.shape_r + state.shape_half_h
                               + torch.sqrt(magnitude2(state.delta)))
                    t_reach_excess = torch.clamp(
                        torch.max(torch.where(alive_own, t_reach, 0.0))
                        - cfg.terrain_grid_cfg.cell_size, min=0.0)
                else:
                    t_width = n_tris
                    t_cand = i32(n_tris)[None, :].expand(n_loc, n_tris)
                    t_ok = torch.ones((n_loc, n_tris), dtype=torch.bool,
                                      device=dev)
                if cfg.stable_pairs and cfg.terrain_bp in ("near", "grid"):
                    t_cand, t_ok = _sorted_pairs(t_cand, t_ok)
                t_tris = torch.where(t_ok, t_cand, 0).T     # (T_w, n)
                tri = gather_triangles(terrain, t_tris)
                tc = _terrain_contact(cfg, ga, tri)
                tc = tc._replace(valid=tc.valid & t_ok.T[None])
                t_lc = LocalContact(local_a=tc.a - (ga.x + ga.delta * tc.t),
                                    local_b=tc.b - world.terrain_center,
                                    contact=tc)
                t_man = prune(t_lc, max_contacts=n_slots, prox_sq=prox)
                t_deep = _deepest(tc)
            tman = _man_to_rows(t_man, t_width, n_loc)
            t_key2 = t_tris.reshape(1, t_width, n_loc).expand(
                n_slots, t_width, n_loc).reshape(-1, n_loc)
            t_rows_n = tman.valid.shape[0]
            if cfg.terrain_rows and t_rows_n > cfg.terrain_rows:
                tman, t_key2 = _top_terrain_rows(tman, t_key2,
                                                 cfg.terrain_rows)
                t_rows_n = cfg.terrain_rows
            blocks.append(tman)
            partners.append(torch.full((t_rows_n, n_loc), m_rows,
                                       dtype=torch.int32, device=dev))
            key2s.append(t_key2)
            max_pen = torch.maximum(max_pen, t_deep)

        man_rows = tree_map(lambda *xs: torch.cat(xs, dim=0), *blocks)
        partner_rows = torch.cat(partners, dim=0)
        key2_rows = torch.cat(key2s, dim=0)
        if cfg.solver_rows and man_rows.valid.shape[0] > cfg.solver_rows:
            man_rows, partner_rows, key2_rows, _ = _compact_rows(
                man_rows, partner_rows, key2_rows, cfg.solver_rows)

        # ---- extended body view: own + halo + one static row ----
        # one message per direction carries the constraint build's fields
        # (and, without fused_iso counts, this frame's contact counts)
        own = _body_fields(state, x_end)                        # (n, 21)
        fill = torch.zeros((1, own.shape[1]), dtype=torch.float32,
                           device=dev)
        if cnt_iso:
            count_comm = 0
        else:
            counts_own = torch.clamp(torch.sum(
                man_rows.valid, dim=0).to(torch.float32), min=1.0)
            own = torch.cat([own, counts_own[:, None]], dim=1)  # (n, 22)
            fill = torch.cat([fill, torch.ones_like(fill[:, :1])], dim=1)
            count_comm = 2 * H
        send = lambda idx, ok: torch.where(ok[:, None], own[idx], fill)
        hl, hr = comm.exchange(send(sl_l, sl_ok), send(sr_l, sr_ok))
        one = torch.ones((1,), dtype=torch.float32, device=dev)
        if cnt_iso:
            counts = torch.cat([cnt_prev, torch.clamp(recv_l[:, 14], min=1.0),
                                torch.clamp(recv_r[:, 14], min=1.0), one])
        else:
            counts = torch.cat([counts_own, torch.clamp(hl[:, 21], min=1.0),
                                torch.clamp(hr[:, 21], min=1.0), one])
        ext = torch.cat([own[:, :21], hl[:, :21], hr[:, :21],
                         torch.zeros_like(fill[:, :21])], dim=0)
        col = lambda k: ext[:, k]
        cv = lambda k: Vec3(col(k), col(k + 1), col(k + 2))
        tcen = world.terrain_center
        bodies_ext = BodyView(
            x=Vec3(*(torch.cat([col(k)[:-1], c.reshape(1)])
                     for k, c in enumerate(tcen))),
            v=cv(3), omega=cv(6), restitution=col(9), friction=col(10),
            inv_mass=col(11),
            inv_moment=Mat3(*(col(12 + k) for k in range(9))))
        rc = build_row_constraints(bodies_ext, partner_rows, man_rows,
                                   cfg.dt, counts=counts,
                                   bias_max=cfg.bias_max)

        # ---- warm-start row matching (global-id keys) ----
        partner_gid = gids[torch.clamp(partner_rows, max=m_rows).long()]
        warm = matched = None
        if use_warm:
            slots_stable = use_cache and cfg.stable_pairs
            if cfg.warm_match == "pos" and slots_stable:
                search = False
            elif cfg.warm_match == "hybrid" and slots_stable:
                search = need      # positional on reuse, search on rebuild
            else:
                search = True
            wn, wt1, wt2, matched = _match_warm(
                warm_in, partner_gid, key2_rows, gid_static, n_tris, search)
            okf = rc.valid.to(torch.float32)
            if cfg.warm_gamma != 1.0:
                okf = okf * cfg.warm_gamma
            warm = (wn * okf, wt1 * okf, wt2 * okf)

        # global warm-hit fraction (the adaptive schedule's trigger),
        # psum'd so every rank sees the same value
        warm_hit_frac = f32(0.0)
        if matched is not None:
            ht = comm.psum(torch.stack([
                torch.sum((matched & rc.valid).to(torch.float32)),
                torch.sum(rc.valid.to(torch.float32))]))
            warm_hit_frac = ht[0] / torch.clamp(ht[1], min=1.0)

        # ---- halo-exchange row solve ----
        S_loc = pack_body_state(state.v, state.omega)       # (8, n_loc)
        ima, Ia = state.inv_mass, state.inv_moment
        zcol = torch.zeros((8, 1), dtype=torch.float32, device=dev)
        sl_ok8, sr_ok8 = sl_ok[None, :], sr_ok[None, :]

        def partner_term(S_loc):
            """vb + wb x rb from own rows + fresh halo rows + static."""
            hl_, hr_ = comm.exchange(
                torch.where(sl_ok8, S_loc[:, sl_l], 0.0),
                torch.where(sr_ok8, S_loc[:, sr_l], 0.0))
            S_glob = torch.cat([S_loc, hl_, hr_, zcol], dim=1)
            g = S_glob[:, rc.partner.long()]
            return (Vec3(g[0], g[1], g[2])
                    + cross(Vec3(g[3], g[4], g[5]), rc.rb))

        def apply_self(S_loc, imp: Vec3):
            imp = imp * rc.valid
            lin = Vec3(-imp.x.sum(0), -imp.y.sum(0), -imp.z.sum(0)) * ima
            ang_pt = -cross(rc.ra, imp)
            ang = mat_vec(Ia, Vec3(ang_pt.x.sum(0), ang_pt.y.sum(0),
                                   ang_pt.z.sum(0)))
            return torch.cat([S_loc[:6] + torch.stack([*lin, *ang]),
                              S_loc[6:]], dim=0)

        def self_term(S_loc):
            va = Vec3(S_loc[0][None], S_loc[1][None], S_loc[2][None])
            oa = Vec3(S_loc[3][None], S_loc[4][None], S_loc[5][None])
            return va + cross(oa, rc.ra)

        def run_solve(S_loc, acc, iters, inner_sweeps):
            acc_n, acc_t1, acc_t2 = acc
            for _ in range(iters):
                frozen = partner_term(S_loc)
                for _ in range(inner_sweeps):
                    dv = frozen - self_term(S_loc)
                    f1, f2, acc_t1, acc_t2 = _friction_impulses(
                        rc, dv, acc_t1, acc_t2, cfg.friction_mode, acc_n)
                    if cfg.two_phase:
                        S_loc = apply_self(S_loc, rc.t1 * f1 + rc.t2 * f2)
                        dv = frozen - self_term(S_loc)
                        fn, acc_n = _normal_impulse(rc, dv, acc_n)
                        S_loc = apply_self(S_loc, rc.normal * fn)
                    else:
                        fn, acc_n = _normal_impulse(rc, dv, acc_n)
                        S_loc = apply_self(
                            S_loc, rc.t1 * f1 + rc.t2 * f2 + rc.normal * fn)
            return S_loc, (acc_n, acc_t1, acc_t2)

        zero = rc.bias * 0.0
        if warm is None:
            acc0 = (zero, zero, zero)
        else:
            wn, wt1, wt2 = warm
            S_loc = apply_self(S_loc, rc.t1 * wt1 + rc.t2 * wt2
                               + rc.normal * wn)
            acc0 = (wn, wt1, wt2)
        iters_used, inner = cfg.solver_iters, cfg.solver_inner
        if cfg.adapt_schedule is not None and matched is not None:
            # the settled schedule once the psum'd warm-hit fraction
            # persists: the same value on every rank, so the same branch
            thr, it2, in2 = cfg.adapt_schedule
            if bool(warm_hit_frac >= thr):
                iters_used, inner = int(it2), int(in2)
        S_loc, (acc_n, acc_t1, acc_t2) = run_solve(S_loc, acc0, iters_used,
                                                   inner)
        v_new, o_new = unpack_body_state(S_loc)
        dv = v_new - state.v
        state = state._replace(v=v_new, omega=o_new)
        warm_out = world.warm
        if use_warm:
            warm_out = SolverWarm(
                partner=torch.where(rc.valid, partner_gid, -9),
                key2=key2_rows, acc_n=acc_n, acc_t1=acc_t1, acc_t2=acc_t2)

        # ---- metrics, reduced over the ranks ----
        comm_floats = 2 * H * 16 + count_comm + iters_used * 2 * H * 8
        f64 = lambda t: t.to(torch.float64).reshape(())
        sums = comm.psum(torch.stack([
            f64(overflow), f64(_isum(pair_ok)), f64(_isum(rc.valid)),
            f64(halo_overflow), f64(stray),
            f64(torch.tensor(comm_floats, device=dev)),
            f64(torch.sum(dv.x * dv.x + dv.y * dv.y + dv.z * dv.z))]))
        maxes = comm.pmax(torch.stack([f64(bp_drift_excess), f64(max_pen),
                                       f64(t_reach_excess)]))
        as_i32 = lambda t: t.to(torch.int32)
        zi, zf = as_i32(f32(0.0)), f32(0.0)
        metrics = {
            "broadphase_overflow": as_i32(sums[0]),
            "broadphase_rebuilt": torch.tensor(need, device=dev),
            "broadphase_cache_drift_excess": maxes[0].to(torch.float32),
            "warm_hit_frac": warm_hit_frac,
            "num_pairs": zi if light else as_i32(sums[1]),
            "num_contacts": zi if light else as_i32(sums[2]),
            "max_penetration": zf if light else maxes[1].to(torch.float32),
            "terrain_reach_excess": maxes[2].to(torch.float32),
            "halo_overflow": as_i32(sums[3]),
            "spatial_stray": as_i32(sums[4]),
            "comm_floats_per_step": as_i32(sums[5]),
            "solver_dv_norm": (zf if light else
                               torch.sqrt(sums[6].to(torch.float32))),
        }
        return world._replace(bodies=state, warm=warm_out, bp=bp_out), metrics

    return step_fn

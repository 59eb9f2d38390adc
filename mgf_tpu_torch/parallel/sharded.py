"""The sharded physics step: bodies distributed over the ranks of a 1-D
mesh (counterpart of ``mgf_tpu.parallel.sharded``, the replicated
all-gather fallback; prefer :mod:`mgf_tpu_torch.parallel.spatial` for
scale).

Per step, on every rank:

* ``complete_motion`` / ``integrate`` over the rank's rows; no
  communication;
* broadphase: the shape view and the constraint build's body fields are
  all-gathered (ONE (N, 35) table: the JAX package gathers each field on
  its own, the values are the same), every rank builds the same cell table
  and generates candidates only for its own rows;
* narrowphase, manifolds and constraint rows over the rank's candidate
  rows, partner shape data read from the gathered table; dense terrain;
* the mass-splitting counts: one more all-gather of (N,);
* solver: the scatter-free single-phase row solve; each rank updates its
  own rows' velocities and the packed (8, N) state is all-gathered once a
  sweep.

The step's metrics are reduced over the ranks (``psum`` / ``pmax``, the
overflow ``psum // n_dev`` as in the JAX package), so every rank returns
the same values.
"""

from __future__ import annotations

import warnings

import torch

from mgf_tpu_torch import broadphase
from mgf_tpu_torch.collision import LocalContact
from mgf_tpu_torch.manifold import prune
from mgf_tpu_torch.math3d import Mat3, Quat, Vec3, cross, mat_vec, tree_map
from mgf_tpu_torch.physics import RigidBodyState, complete_motion, integrate
from mgf_tpu_torch.solver import (
    BodyView, _friction_impulses, _normal_impulse, build_row_constraints,
    pack_body_state, unpack_body_state,
)
from mgf_tpu_torch.world import (
    PackedShapes, ShapeView, World, WorldConfig, _body_bounds, _deepest,
    _isum, _man_to_rows, _pair_contact, _terrain_contact, gather_shapes,
    manifold_prox_sq, self_shapes, shape_view,
)


def pad_bodies(state: RigidBodyState, multiple: int) -> RigidBodyState:
    """Pad the body SoA to a row count divisible by ``multiple`` with inert
    static bodies (inv_mass 0, zero force) parked far from the scene, at x
    = 1e5 + 100 k, y = z = 1e5.  Pads carry ``shape_r = -1``, the "not a
    real body" marker every grid build skips."""
    n = state.n_bodies
    pad = (-n) % multiple
    if pad == 0:
        return state
    state = tree_map(lambda g: torch.cat([g, torch.zeros(
        (pad,) + g.shape[1:], dtype=g.dtype, device=g.device)]), state)
    dev = state.inv_mass.device
    far = 1.0e5 + 100.0 * torch.arange(pad, dtype=torch.float32, device=dev)
    full = lambda v: torch.full((pad,), v, dtype=torch.float32, device=dev)
    fix = lambda g, tail: torch.cat([g[:n], tail])
    return state._replace(
        x=Vec3(fix(state.x.x, far), fix(state.x.y, full(1.0e5)),
               fix(state.x.z, full(1.0e5))),
        q=state.q._replace(w=fix(state.q.w, full(1.0))),
        shape_r=fix(state.shape_r, full(-1.0)))


def rank_rows(tree, rank: int, n_loc: int, device):
    """Rows ``rank * n_loc .. (rank + 1) * n_loc`` of every (N, ...) leaf,
    on ``device``."""
    lo = rank * n_loc
    return tree_map(lambda g: g[lo:lo + n_loc].to(device).contiguous(), tree)


def replicated(world: World, device) -> dict:
    """The world's terrain fields, whole, on ``device``."""
    to = lambda t: tree_map(lambda g: g.to(device), t)
    return dict(terrain=to(world.terrain),
                terrain_center=to(world.terrain_center),
                terrain_grid=(None if world.terrain_grid is None
                              else world.terrain_grid.to(device)))


def shard_world(world: World, comm) -> World:
    """This rank's shard: the body rows padded with inert statics to a
    multiple of the rank count and cut in rank order; terrain replicated."""
    padded = pad_bodies(world.bodies, comm.size)
    n_loc = padded.n_bodies // comm.size
    rep = replicated(world, comm.device)
    return World(bodies=rank_rows(padded, comm.rank, n_loc, comm.device),
                 terrain=rep["terrain"],
                 terrain_center=rep["terrain_center"])


def make_sharded_step(cfg: WorldConfig, comm):
    """The sharded step over ``comm``'s ranks (the replicated all-gather
    fallback).  Always the scatter-free row solver in its single-phase
    form; the config options this path does not honor warn."""
    if cfg.two_phase:
        warnings.warn(
            "sharded step solves friction+normal from one relative "
            "velocity (single-phase); cfg.two_phase=True is not honored — "
            "set two_phase=False or use parallel.spatial", stacklevel=2)
    if cfg.terrain_rows:
        warnings.warn(
            "sharded step does not compact terrain rows; cfg.terrain_rows "
            "is ignored — use parallel.spatial", stacklevel=2)
    if cfg.bp_every > 1:
        warnings.warn(
            "sharded step rebuilds its broadphase every step; "
            "cfg.bp_every (rebuild cadence) is ignored", stacklevel=2)
    n_slots = 1 if cfg.shape_mode == "spheres" else 2
    window = "sel8" if cfg.broadphase == "fat8" else "27"

    def step_fn(world: World):
        state = complete_motion(world.bodies)
        state = integrate(state, cfg.dt)
        terrain, center = world.terrain, world.terrain_center
        n_loc = state.n_bodies
        dev = state.inv_mass.device
        row0 = comm.axis_index() * n_loc
        rows_g = row0 + torch.arange(n_loc, dtype=torch.int32, device=dev)
        n_tris = terrain.a.x.shape[0]

        # ---- ONE all-gather: the shape view and the body fields ----
        x_end = state.x + state.delta
        im = state.inv_moment
        table = comm.all_gather_tiled(torch.stack([
            *state.x, *state.q, *state.delta,
            state.shape_type.to(torch.float32), state.shape_r,
            state.shape_half_h, *x_end, *state.v, *state.omega,
            state.restitution, state.friction, state.inv_mass, *im],
            dim=-1))                                          # (N, 35)
        col = lambda k: table[:, k]
        gview = ShapeView(x=Vec3(col(0), col(1), col(2)),
                          q=Quat(col(3), col(4), col(5), col(6)),
                          delta=Vec3(col(7), col(8), col(9)),
                          shape_type=col(10).to(torch.int32),
                          shape_r=col(11), shape_half_h=col(12))
        n_glob = table.shape[0]
        ps = PackedShapes(p8=torch.stack([
            *gview.x, *gview.delta, gview.shape_r, gview.shape_half_h,
            *gview.q, col(10)], dim=-1), shape_type=gview.shape_type)

        # ---- broadphase: replicated table, local candidate rows ----
        bounds_g = broadphase.swept_fat_bounds(
            _body_bounds(cfg, gview), gview.delta, cfg.fatten)
        grid = broadphase.build_fat_grid(bounds_g, cfg.grid,
                                         valid=gview.shape_r > 0.0)
        local_centers = tree_map(lambda g: g[row0:row0 + n_loc], bounds_g.c)
        partner, pair_ok = broadphase.fat_grid_pairs(
            bounds_g, grid, cfg.grid, cfg.max_pairs, self_rows=rows_g,
            ordered=False, query_centers=local_centers, window=window)

        # ---- narrowphase over local candidate rows, slot-major (K, n) ----
        K = partner.shape[1]
        partner_t, pair_ok_t = partner.T, pair_ok.T
        ga = self_shapes(cfg, shape_view(state))          # (1, n) self
        gb = gather_shapes(cfg, ps, torch.where(pair_ok_t, partner_t, 0))
        pc = _pair_contact(cfg, ga, gb)
        pc = pc._replace(valid=pc.valid & pair_ok_t[None])
        lc = LocalContact(local_a=pc.a - (ga.x + ga.delta * pc.t),
                          local_b=pc.b - (gb.x + gb.delta * pc.t),
                          contact=pc)
        prox = manifold_prox_sq(cfg)
        blocks = [_man_to_rows(prune(lc, max_contacts=n_slots,
                                     prox_sq=prox), K, n_loc)]
        partners = [torch.where(pair_ok_t, partner_t, n_glob)[None].expand(
            n_slots, K, n_loc).reshape(-1, n_loc)]
        max_pen = _deepest(pc)
        if n_tris > 0:
            # dense terrain: every (triangle, own body) pair
            tri = tree_map(lambda g: g[:, None].expand(n_tris, n_loc),
                           terrain)
            tc = _terrain_contact(cfg, ga, tri)
            t_lc = LocalContact(local_a=tc.a - (ga.x + ga.delta * tc.t),
                                local_b=tc.b - center, contact=tc)
            blocks.append(_man_to_rows(prune(t_lc, max_contacts=n_slots,
                                             prox_sq=prox), n_tris, n_loc))
            max_pen = torch.maximum(max_pen, _deepest(tc))
            partners.append(torch.full((n_slots * n_tris, n_loc), n_glob,
                                       dtype=torch.int32, device=dev))
        man_rows = tree_map(lambda *xs: torch.cat(xs, dim=0), *blocks)
        partner_rows = torch.cat(partners, dim=0)

        # ---- replicated extended body view (+ one static row) ----
        srow = lambda g: torch.cat([g, torch.zeros(
            (1,), dtype=g.dtype, device=dev)])
        cv = lambda k: Vec3(srow(col(k)), srow(col(k + 1)), srow(col(k + 2)))
        bodies_ext = BodyView(
            x=Vec3(*(torch.cat([col(13 + k), c.reshape(1)])
                     for k, c in enumerate(center))),
            v=cv(16), omega=cv(19), restitution=srow(col(22)),
            friction=srow(col(23)), inv_mass=srow(col(24)),
            inv_moment=Mat3(*(srow(col(25 + k)) for k in range(9))))

        # mass splitting: local row counts, all-gathered for partners
        counts_loc = torch.clamp(
            torch.sum(man_rows.valid, dim=0).to(torch.float32), min=1.0)
        counts = torch.cat([comm.all_gather_tiled(counts_loc),
                            torch.ones((1,), dtype=torch.float32,
                                       device=dev)])
        rc = build_row_constraints(bodies_ext, partner_rows, man_rows,
                                   cfg.dt, counts=counts, col_offset=row0,
                                   bias_max=cfg.bias_max)

        # ---- scatter-free sharded row solve ----
        S_loc = pack_body_state(state.v, state.omega)      # (8, n_loc)
        ima, Ia = state.inv_mass, state.inv_moment
        zcol = torch.zeros((8, 1), dtype=torch.float32, device=dev)

        def rel_vel(S_glob, S_loc):
            g = S_glob[:, rc.partner.long()]
            vb, ob = Vec3(g[0], g[1], g[2]), Vec3(g[3], g[4], g[5])
            va = Vec3(S_loc[0][None], S_loc[1][None], S_loc[2][None])
            oa = Vec3(S_loc[3][None], S_loc[4][None], S_loc[5][None])
            return (vb + cross(ob, rc.rb)) - (va + cross(oa, rc.ra))

        def apply_self(S_loc, imp: Vec3):
            imp = imp * rc.valid
            lin = Vec3(-imp.x.sum(0), -imp.y.sum(0), -imp.z.sum(0)) * ima
            ang_pt = -cross(rc.ra, imp)
            ang = mat_vec(Ia, Vec3(ang_pt.x.sum(0), ang_pt.y.sum(0),
                                   ang_pt.z.sum(0)))
            z = torch.zeros_like(lin.x)
            return S_loc + torch.stack([*lin, *ang, z, z], dim=0)

        acc_n = acc_t1 = acc_t2 = rc.bias * 0.0
        for _ in range(cfg.solver_iters):
            S_g = torch.cat([comm.all_gather_tiled(S_loc, dim=1), zcol],
                            dim=1)
            dv = rel_vel(S_g, S_loc)
            f1, f2, acc_t1, acc_t2 = _friction_impulses(
                rc, dv, acc_t1, acc_t2, cfg.friction_mode, acc_n)
            fn, acc_n = _normal_impulse(rc, dv, acc_n)
            S_loc = apply_self(S_loc, rc.t1 * f1 + rc.t2 * f2
                               + rc.normal * fn)
        v_new, o_new = unpack_body_state(S_loc)
        dv = v_new - state.v
        state = state._replace(v=v_new, omega=o_new)

        # ---- metrics, reduced over the ranks ----
        sums = comm.psum(torch.stack([
            grid.overflow.to(torch.float64), _isum(pair_ok).to(torch.float64),
            _isum(rc.valid).to(torch.float64),
            torch.sum(dv.x * dv.x + dv.y * dv.y + dv.z * dv.z).to(
                torch.float64)]))
        i32 = lambda v: v.to(torch.int32)
        metrics = {
            # identical on every rank (one replicated table): psum // n_dev
            "broadphase_overflow": i32(sums[0]) // comm.size,
            "num_pairs": i32(sums[1]),
            "num_contacts": i32(sums[2]),
            "max_penetration": comm.pmax(max_pen),
            "solver_dv_norm": torch.sqrt(sums[3].to(torch.float32)),
        }
        return world._replace(bodies=state), metrics

    return step_fn

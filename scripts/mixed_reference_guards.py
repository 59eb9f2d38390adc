"""What mgf_tpu's own mixed sphere/capsule pile does while it collapses: the
reference numbers behind the guards that chip_smoke.py [11] holds the
PyTorch port to.  With ``--capsules NUM`` it steps the capsules demo
``capsules_scene(NUM)`` instead (the reference beside chip_smoke.py [13]);
with ``--balls sequential|parallel`` the 1,332-ball demo on the flat
reference solvers (chip_smoke.py [15] and [16]: the sequential one with the
reference's raw-lambda friction, the parallel one with the demo's default);
with ``--terrain N`` the heightfield scene ``terrain_scene(N)``
(chip_smoke.py [17]); with ``--gjk`` GJK/EPA (``contact_convex_convex_ex``
and ``separation``, jitted) on bench.py's 8,192 OBB pairs against the f64
SAT oracle (chip_smoke.py [19]'s ``GJK_REFERENCE``); with
``--fat-variants`` the sphere pile ``stress_scene(--bodies)`` in the
broadphase modes fat27x4 (the scene's own), fat, fat8 and fat8x4 on
chip_smoke.py [21]'s grids, 64 steps from the initial block: the pair reach
excess at each 16th step (where chip_smoke.py's light chunks report it)
and its worst over every step, overflow, drift excess, contacts and max
penetration at the last step.  With ``--oracle balls|flagship|mixed`` the
f64 oracle's per-step resync against mgf_tpu's own step, at chip_smoke.py
[29], [31] and [32]'s scenes and windows (the oracle alone for ``--settle``
steps, then each step its state pushed into the step and the contact
streams diffed, as scripts/parity_curves.py and scripts/mixed_resync.py
do): the 1,332-ball demo on the generic branch with the Pallas pair
kernel (interpreted on the CPU), stress_scene(--bodies) on
its shipped fused_iso config with the warm rows and the bp_every cache
carried from step to step, and the 6-layer mixed pile with
cap_manifold="ends"; with ``--oracle cold`` scripts/cold_bridge.py's row
(the cold 20-sweep config on stress_scene(--bodies), max penetration at
every 30th step from 150 on).  With ``--spatial`` the sphere pile
``stress_scene(--bodies)`` on mgf_tpu's spatial (x-slab halo-exchange)
step over 4 virtual CPU devices beside its single-device step, both from
the same state with fresh caches (after ``--settle`` single-device steps
from the initial block): at every 16th step and the last, the contact
counts of both and their ratio, the largest position gap of one body
between the two runs, the halo rows the pile needs (the most live bodies
of one shard within the halo band of one slab edge: the cell size plus the
body's build slack) and the halo metrics at ``--halo`` (chip_smoke.py [26]
and [27]'s guards).

Steps ``mgf_tpu.scenes.stress_scene(--bodies, mixed=True)`` with the JAX
package on the CPU for ``--steps`` steps from the initial block and prints
max penetration at step 128, at the last step and at its peak, the per-step
bucket overflow (the bodies the fat grid drops from full buckets: cell 2.0,
cap 14), the worst step's share of the bodies, and the count of bodies below
y = -1 or outside the walls.

    JAX_PLATFORMS=cpu python scripts/mixed_reference_guards.py --bodies 8000
    JAX_PLATFORMS=cpu python scripts/mixed_reference_guards.py --capsules 5 \
        --steps 416
    JAX_PLATFORMS=cpu python scripts/mixed_reference_guards.py \
        --balls sequential --steps 280
    JAX_PLATFORMS=cpu python scripts/mixed_reference_guards.py \
        --terrain 2000 --steps 240
    JAX_PLATFORMS=cpu python scripts/mixed_reference_guards.py --gjk
    JAX_PLATFORMS=cpu python scripts/mixed_reference_guards.py \
        --fat-variants --bodies 8000 --steps 64
    JAX_PLATFORMS=cpu python scripts/mixed_reference_guards.py \
        --spatial --bodies 8000 --steps 128 --halo 1024
    JAX_PLATFORMS=cpu python scripts/mixed_reference_guards.py \
        --spatial --bodies 8000 --settle 40 --steps 8 --halo 1024
    JAX_PLATFORMS=cpu python scripts/mixed_reference_guards.py \
        --oracle flagship --bodies 2000     # balls | flagship | mixed | cold

Takes about 0.5 s per step at 8,000 bodies and 1.7 s at 30,000 on 8 CPU
cores, after a 20-40 s compile; the capsules demo about 8 min at NUM = 5
for 416 steps and over 40 min at NUM = 11.  The balls demo and the terrain
scene print their step time; ``--gjk`` takes about 80 s.  Imports the JAX
package and, for ``--gjk``, chip_smoke.py's numpy pairs and SAT oracle:
nothing of the port.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bodies", type=int, default=8000)
    ap.add_argument("--steps", type=int, default=192)
    ap.add_argument("--capsules", type=int, default=0, metavar="NUM",
                    help="step capsules_scene(NUM) instead of the mixed pile")

    ap.add_argument("--balls", choices=("sequential", "parallel"),
                    help="step balls_scene(11) on this flat solver instead")
    ap.add_argument("--terrain", type=int, default=0, metavar="N",
                    help="step terrain_scene(N) instead")
    ap.add_argument("--gjk", action="store_true",
                    help="GJK/EPA on bench.py's 8,192 OBB pairs instead")
    ap.add_argument("--fat-variants", action="store_true",
                    help="the sphere pile in each fat broadphase mode")
    ap.add_argument("--spatial", action="store_true",
                    help="the sphere pile on the spatial step (4 devices) "
                    "beside the single-device step")
    ap.add_argument("--settle", type=int, default=0,
                    help="--spatial: single-device steps before the two "
                    "runs start")
    ap.add_argument("--halo", type=int, default=1024,
                    help="--spatial: halo rows per direction")
    ap.add_argument("--oracle", choices=("balls", "flagship", "mixed",
                                         "cold"),
                    help="the f64 oracle's resync of chip_smoke.py [29], "
                    "[31] or [32], or cold_bridge.py's row, instead")
    args = ap.parse_args()
    if args.oracle == "cold":
        return cold_bridge(args.bodies)
    if args.oracle:
        return oracle_resync(args.oracle, args.bodies)
    if args.gjk:
        return gjk_pairs()
    if args.fat_variants:
        return fat_variants(args.bodies, args.steps)
    if args.spatial:
        return spatial(args.bodies, args.steps, args.settle, args.halo)

    import jax
    from mgf_tpu.scenes import capsules_scene, stress_scene
    from mgf_tpu.world import step

    if args.balls:
        return balls(args.balls, args.steps)
    if args.terrain:
        return terrain(args.terrain, args.steps)
    if args.capsules:
        world, cfg = capsules_scene(args.capsules)
    else:
        world, cfg = stress_scene(args.bodies, mixed=True)
    f = jax.jit(functools.partial(step, cfg=cfg))
    pen, over = [], []
    for _ in range(args.steps):
        world, m = f(world)
        pen.append(float(m["max_penetration"]))
        over.append(int(m["broadphase_overflow"]))
    x = np.stack([np.asarray(c) for c in world.bodies.x], -1)
    if args.capsules:
        inside = ((np.abs(x[:, 0]) < 10.0) & (np.abs(x[:, 2]) < 10.0)
                  & (x[:, 1] > -10.0))
        at280 = f"{pen[279]:.4f}" if args.steps >= 280 else "not reached"
        print(f"mgf_tpu capsules_scene({args.capsules}), {x.shape[0]} "
              f"capsules, {args.steps} steps on "
              f"{jax.devices()[0].platform}: max penetration at step 280 "
              f"{at280}, at step {args.steps} {pen[-1]:.4f}, peak "
              f"{max(pen):.4f} (step {int(np.argmax(pen)) + 1}); contacts "
              f"{int(m['num_contacts'])}; bucket overflow worst step "
              f"{max(over)}; inside the box {int(inside.sum())}, missed it "
              f"and falling {int((~inside).sum())}")
        return
    wall = float(np.abs(np.asarray(world.terrain.a.x)).max())
    escaped = int(((x[:, 1] < -1.0) | (np.abs(x[:, 0]) > wall)
                   | (np.abs(x[:, 2]) > wall)).sum())
    at128 = f"{pen[127]:.4f}" if args.steps >= 128 else "not reached"
    print(f"mgf_tpu mixed pile, {args.bodies} bodies, {args.steps} steps on "
          f"{jax.devices()[0].platform}: max penetration at step 128 "
          f"{at128}, at step {args.steps} {pen[-1]:.4f}, peak "
          f"{max(pen):.4f} (step {int(np.argmax(pen)) + 1}); contacts "
          f"{int(m['num_contacts'])}; escaped bodies {escaped}")
    print(f"bucket overflow: worst step {max(over)} bodies "
          f"({100.0 * max(over) / args.bodies:.4f} % of the bodies), on "
          f"{sum(o > 0 for o in over)} of {args.steps} steps, first at step "
          f"{next((k + 1 for k, o in enumerate(over) if o), None)}; within "
          f"the first 128 steps worst {max(over[:128])}")


def _series(name, xs):
    nz = [k + 1 for k, o in enumerate(xs) if o]
    return (f"{name}: worst step {max(xs)}, on {len(nz)} of {len(xs)} "
            f"steps, first at step {nz[0] if nz else None}")


def balls(solver, steps):
    """The 1,332-ball demo on a flat reference solver: the overflow series,
    contacts and max penetration at the last step, bodies out of the box."""
    import time

    import jax
    from mgf_tpu.scenes import balls_scene
    from mgf_tpu.world import step

    world, cfg = balls_scene(11, solver=solver)
    if solver == "sequential":
        cfg = cfg._replace(friction_mode="mgf")
    f = jax.jit(functools.partial(step, cfg=cfg))
    pen, over, t0 = [], [], None
    for k in range(steps):
        if k == 1:
            jax.block_until_ready(world)
            t0 = time.perf_counter()
        world, m = f(world)
        pen.append(float(m["max_penetration"]))
        over.append(int(m["broadphase_overflow"]))
    dt = (time.perf_counter() - t0) / max(steps - 1, 1)
    x = np.stack([np.asarray(c) for c in world.bodies.x], -1)
    # the demo box: floor y = -10, walls |x|, |z| = 10
    out = int(((x[:, 1] < -10.0) | (np.abs(x[:, 0]) > 10.0)
               | (np.abs(x[:, 2]) > 10.0)).sum())
    print(f"mgf_tpu balls_scene(11, solver={solver!r}, friction_mode="
          f"{cfg.friction_mode!r}), {x.shape[0]} bodies, {steps} steps on "
          f"{jax.devices()[0].platform} ({dt:.3f} s a step): max "
          f"penetration at the last step {pen[-1]:.4f}, peak {max(pen):.4f} "
          f"(step {int(np.argmax(pen)) + 1}); contacts "
          f"{int(m['num_contacts'])}; out of the box {out}; lowest y "
          f"{x[:, 1].min():.4f}")
    print(_series("broadphase overflow", over) + f"; worst in steps 1-200 "
          f"{max(over[:200])}, in 201-{steps} {max(over[200:], default=0)}")


def terrain(n_bodies, steps):
    """terrain_scene(n_bodies): the lowest and highest body against the
    start, the face grid's overflow, terrain_reach_excess on every step,
    max penetration, and the contacts by class at the last step."""
    import time

    import jax
    from mgf_tpu.mesh import build_mesh_grid, mesh_from_arrays
    from mgf_tpu.scenes import terrain_scene
    from mgf_tpu.world import step

    world, cfg = terrain_scene(n_bodies)
    tri = world.terrain
    corners = [np.stack([np.asarray(c) for c in p], -1)
               for p in (tri.a, tri.b, tri.c)]
    T = corners[0].shape[0]
    faces = np.stack([np.arange(T), T + np.arange(T), 2 * T + np.arange(T)],
                     -1)
    tg = cfg.terrain_grid_cfg
    mg = build_mesh_grid(mesh_from_arrays(np.concatenate(corners), faces),
                         tg.cell_size, tg.dim, tg.bucket_cap)
    y0 = np.asarray(world.bodies.x.y)
    f = jax.jit(functools.partial(step, cfg=cfg))
    g = jax.jit(functools.partial(step, cfg=cfg, collect_contacts=True))
    pen, excess, dropped, over, t0, dt = [], [], [], [], None, float("nan")
    for k in range(steps):
        if k in (1, steps - 1):
            jax.block_until_ready(world)
            if k == 1:
                t0 = time.perf_counter()
            else:       # the last step compiles the collecting variant
                dt = (time.perf_counter() - t0) / max(steps - 2, 1)
        world, m = (g if k == steps - 1 else f)(world)
        pen.append(float(m["max_penetration"]))
        excess.append(float(m["terrain_reach_excess"]))
        dropped.append(int(m["solver_rows_dropped"]))
        over.append(int(m["broadphase_overflow"]))
    y = np.asarray(world.bodies.x.y)
    n_pair = int(np.asarray(m["pair_contacts"]["contact"].valid).sum())
    n_terr = int(np.asarray(m["terrain_contacts"]["contact"].valid).sum())
    print(f"mgf_tpu terrain_scene({n_bodies}), {T} faces, {steps} steps on "
          f"{jax.devices()[0].platform} (about {dt:.3f} s a step): face "
          f"grid overflow {int(mg.overflow)}; terrain_reach_excess worst "
          f"{max(excess):.4f}; lowest body y {y.min():.4f}, highest "
          f"{y.max():.4f} (start {y0.max():.4f}), rise over start "
          f"{(y - y0).max():.4f}")
    print(f"max penetration at the last step {pen[-1]:.4f}, peak "
          f"{max(pen):.4f} (step {int(np.argmax(pen)) + 1}); contacts at "
          f"the last step {int(m['num_contacts'])}: pair {n_pair}, terrain "
          f"{n_terr}; solver_rows_dropped at the last step {dropped[-1]}, "
          f"worst {max(dropped)}")
    print(_series("broadphase overflow", over) + f"; at the last step "
          f"{over[-1]}")


def gjk_pairs():
    """mgf_tpu's contact and separation on chip_smoke.py [19]'s pairs, held
    to the same SAT oracle."""
    import jax
    import jax.numpy as jnp
    from chip_smoke import N_GJK, bench_obb_arrays, sat_depth, sat_oracle
    from mgf_tpu.geom import OBB, support_obb
    from mgf_tpu.gjk import contact_convex_convex_ex, separation
    from mgf_tpu.math3d import Quat, Vec3
    boxes = bench_obb_arrays(N_GJK)
    a, b = (OBB(c=Vec3(*(jnp.asarray(c[:, k]) for k in range(3))),
                q=Quat(*(jnp.asarray(q[:, k]) for k in range(4))),
                r=Vec3(*(jnp.asarray(r[:, k]) for k in range(3))))
            for c, q, r in boxes)

    def run():
        sa = lambda d: support_obb(a, d)
        sb = lambda d: support_obb(b, d)
        ones = jnp.ones(N_GJK, jnp.float32)
        c, sat = contact_convex_convex_ex(sa, sb, ones)
        dist, sep = separation(sa, sb, ones)
        depth = ((c.b.x - c.a.x) * c.n.x + (c.b.y - c.a.y) * c.n.y
                 + (c.b.z - c.a.z) * c.n.z)
        return dict(valid=c.valid, sat=sat, depth=depth, dist=dist, sep=sep)
    out = {k: np.asarray(v) for k, v in jax.jit(run)().items()}
    depth_sat = sat_depth(*(x.astype(np.float64) for box in boxes
                            for x in box))
    print(f"mgf_tpu GJK/EPA on {N_GJK} OBB pairs on "
          f"{jax.devices()[0].platform}: {sat_oracle(out, depth_sat)}, "
          f"EPA-saturated lanes {int(out['sat'].sum())}")


def fat_variants(n_bodies, steps):
    """stress_scene(n_bodies) in each fat broadphase mode, the solver in
    plain jnp (the same math as its Pallas kernel)."""
    import jax
    from mgf_tpu.broadphase import GridConfig
    from mgf_tpu.scenes import stress_scene
    from mgf_tpu.world import step
    for mode in ("fat27x4", "fat", "fat8", "fat8x4"):
        world, cfg = stress_scene(n_bodies)
        cfg = cfg._replace(broadphase=mode, pallas_solver=False)
        if mode in ("fat8", "fat8x4"):
            # chip_smoke.py [21]: cell 2.4, cap 24, the scene's x/z rule
            wall = float(np.abs(np.asarray(world.terrain.a.x)).max())
            dim = 32
            while dim * 2.4 < 2.0 * wall + 10.0:
                dim *= 2
            cfg = cfg._replace(grid=GridConfig(2.4, (dim, 16, dim), 24))
        f = jax.jit(functools.partial(step, cfg=cfg))
        reach, over, drift = [], [], []
        for _ in range(steps):
            world, m = f(world)
            reach.append(float(m["broadphase_reach_excess"]))
            over.append(int(m["broadphase_overflow"]))
            drift.append(float(m["broadphase_cache_drift_excess"]))
        ends = [round(reach[k - 1], 6) for k in range(16, steps + 1, 16)]
        print(f"mgf_tpu stress_scene({n_bodies}) broadphase={mode} grid "
              f"{tuple(cfg.grid)}, {steps} steps on "
              f"{jax.devices()[0].platform}: reach excess at steps 16, 32, "
              f"... {ends}, worst {max(reach):.6f} (step "
              f"{int(np.argmax(reach)) + 1}); overflow worst step "
              f"{max(over)}; drift excess worst {max(drift)}; contacts "
              f"{int(m['num_contacts'])}; max penetration "
              f"{float(m['max_penetration']):.4f}", flush=True)


N_DEV = 4


def spatial(n_bodies, steps, settle, halo):
    """stress_scene(n_bodies) on the spatial step over N_DEV virtual CPU
    devices beside the single-device step, from the same state."""
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_"
                                   f"device_count={N_DEV}").strip()
    import jax
    from jax.sharding import Mesh
    from mgf_tpu.parallel import (init_spatial_bp_cache, make_spatial_step,
                                  shard_world_spatial)
    from mgf_tpu.scenes import stress_scene
    from mgf_tpu.world import init_bp_cache, init_warm, step
    world, cfg = stress_scene(n_bodies)
    f = jax.jit(functools.partial(step, cfg=cfg))
    for _ in range(settle):
        world, _ = f(world)
    world = world._replace(warm=None, bp=None)
    mesh = Mesh(np.array(jax.devices("cpu")[:N_DEV]), ("b",))
    assert mesh.devices.size == N_DEV
    hw = cfg.grid.cell_size
    wsp, bounds = shard_world_spatial(world, mesh, cfg=cfg)
    wsp = init_spatial_bp_cache(wsp, mesh, cfg, halo=halo)
    fsp = make_spatial_step(cfg, mesh, bounds, halo=halo, halo_width=hw)
    single = init_bp_cache(init_warm(world, cfg), cfg)
    order = np.argsort(np.asarray(world.bodies.x.x), kind="stable")
    n_loc = wsp.bodies.n_bodies // N_DEV
    need, hov, stray, rebuilds = 0, 0, 0, 0
    for k in range(1, steps + 1):
        single, ms = f(single)
        wsp, msp = fsp(wsp)
        hov = max(hov, int(msp["halo_overflow"]))
        stray = max(stray, int(msp["spatial_stray"]))
        rebuilds += int(msp["broadphase_rebuilt"])
        b = wsp.bodies
        x = np.asarray(b.x.x) + np.asarray(b.delta.x)
        band = hw + np.asarray(wsp.bp.slack)
        alive = np.asarray(b.shape_r) > 0.0
        for e in range(1, N_DEV):
            lo_sh = slice((e - 1) * n_loc, e * n_loc)
            hi_sh = slice(e * n_loc, (e + 1) * n_loc)
            need = max(need, int(np.sum(
                alive[lo_sh] & (x[lo_sh] >= bounds[e] - band[lo_sh]))),
                int(np.sum(alive[hi_sh]
                           & (x[hi_sh] <= bounds[e] + band[hi_sh]))))
        if k % 16 and k != steps:
            continue
        pos = lambda w: np.stack([np.asarray(c) for c in w.bodies.x], -1)
        gap = float(np.abs(pos(wsp)[:n_bodies] - pos(single)[order]).max())
        c_sp, c_1 = int(msp["num_contacts"]), int(ms["num_contacts"])
        print(f"step {k}: contacts spatial {c_sp} / single {c_1} (ratio "
              f"{c_sp / max(c_1, 1):.6f}), position gap {gap:.6g}, max "
              f"penetration {float(msp['max_penetration']):.4f} / "
              f"{float(ms['max_penetration']):.4f}; halo rows needed so far "
              f"{need} (halo {halo}, n_loc {n_loc}), halo_overflow worst "
              f"{hov}, stray worst {stray}, rebuilds {rebuilds}, "
              f"warm_hit_frac {float(msp['warm_hit_frac']):.4f}, "
              f"comm_floats_per_step {int(msp['comm_floats_per_step'])}",
              flush=True)
    print(f"mgf_tpu stress_scene({n_bodies}) after {settle} single-device "
          f"steps, {steps} steps spatial on {N_DEV} "
          f"{jax.devices()[0].platform} devices beside single-device",
          flush=True)


# chip_smoke.py's windows: (oracle-only steps, resync steps)
ORACLE_WINDOWS = {"balls": (60, 160), "flagship": (100, 100),
                  "mixed": (150, 120)}


def oracle_resync(case, n_bodies):
    """mgf_tpu's own resync against the f64 oracle at chip_smoke.py [29],
    [31] or [32]'s scene and windows: the worst deltas, the misses and the
    steps they fall on, the one-step velocity gap, the ends slot-1 and
    capsule-terrain counts."""
    import time

    import jax
    from mgf_tpu import oracle
    from mgf_tpu.scenes import balls_scene, stress_scene
    from mgf_tpu.world import step
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "..", "tests"))
    from test_oracle import _diff_streams

    settle, steps = ORACLE_WINDOWS[case]
    kw = {}
    if case == "balls":
        world, cfg = balls_scene(11)
        cfg = cfg._replace(pallas_narrowphase=True)   # [29] runs K2
        kw = dict(mgf_friction=True)
    elif case == "flagship":
        world, cfg = stress_scene(n_bodies)
    else:
        world, cfg = stress_scene(n_bodies, mixed=True, layers=6)
        kw = dict(cap_manifold="ends")
    carry = case == "flagship"
    f = jax.jit(functools.partial(step, cfg=cfg, collect_contacts=True))
    ow = oracle.from_world(world)
    t0 = time.perf_counter()
    for _ in range(settle):
        ow, _ = oracle.oracle_step(ow, dt=cfg.dt, iters=cfg.solver_iters,
                                   **kw)
    worst = dict(dt=0.0, dn=0.0, dp=0.0, miss=0, total=0)
    stype = np.asarray(world.bodies.shape_type)
    template, dvs, miss_steps, hit = world, [], [], []
    slot1 = cterr = 0
    for s in range(steps):
        w, m = f(oracle.to_world(ow, template))
        ow, rec = oracle.oracle_step(ow, dt=cfg.dt, iters=cfg.solver_iters,
                                     **kw)
        before = worst["miss"]
        worst = _diff_streams(m, rec, worst)
        if worst["miss"] > before:
            miss_steps.append((settle + s + 1, worst["miss"] - before))
        dvs.append(float(np.abs(np.asarray(w.bodies.v.y)
                                - ow.v[:, 1]).max()))
        hit.append(float(m["warm_hit_frac"]))
        kind = np.asarray(rec["kind"])
        slot1 += int(np.sum((kind == 1) & (np.asarray(rec["slot"]) == 1)))
        cterr += int(np.sum((kind == 0)
                            & (stype[np.asarray(rec["i"], np.int64)] == 1)))
        if carry:
            template = w
    dvs = np.asarray(dvs)
    print(f"mgf_tpu oracle resync {case} ({stype.shape[0]} bodies) on "
          f"{jax.devices()[0].platform}, oracle alone {settle} steps, "
          f"resync {steps} (caches carried: {carry}) in "
          f"{time.perf_counter() - t0:.1f} s: contacts compared "
          f"{worst['total']}, miss {worst['miss']} (on steps "
          f"{miss_steps}), dt {worst['dt']:.3g}, dn {worst['dn']:.3g}, dp "
          f"{worst['dp']:.3g}; one-step |dv| median {np.median(dvs):.3g}, "
          f"max {dvs.max():.3g}, steps > 5: {int((dvs > 5.0).sum())}; "
          f"ends slot-1 {slot1}, capsule-terrain {cterr}; warm_hit_frac "
          f"min {min(hit):.4f}", flush=True)


def cold_bridge(n_bodies, steps=300, sample=30):
    """scripts/cold_bridge.py's row: the cold 20-sweep config (warm
    starting and fused_iso off, bp_every 1) on stress_scene(n_bodies),
    max penetration at every ``sample``-th step from step 150 on."""
    import jax
    from mgf_tpu.scenes import stress_scene
    from mgf_tpu.world import step
    w, cfg = stress_scene(n_bodies)
    cfg = cfg._replace(warm_start=False, fused_iso=False,
                       warm_match="search", adapt_schedule=None,
                       solver_iters=20, solver_inner=1, two_phase=True,
                       bp_every=1)
    w = w._replace(warm=None, bp=None)
    f = jax.jit(functools.partial(step, cfg=cfg))
    pens = []
    for s in range(steps):
        w, m = f(w)
        if (s + 1) % sample == 0 and s + 1 >= 150:
            pens.append(float(m["max_penetration"]))
    print(f"mgf_tpu cold_bridge.py row, stress_scene({n_bodies}), 20 "
          f"two-phase sweeps, {steps} steps on {jax.devices()[0].platform}: "
          f"max penetration at steps {list(range(150, steps + 1, sample))} "
          f"{[round(p, 4) for p in pens]}, range {min(pens):.4f}-"
          f"{max(pens):.4f} (oracle f64 cold-GS at 2k: 0.073-0.081); "
          f"contacts {int(m['num_contacts'])}", flush=True)


if __name__ == "__main__":
    main()

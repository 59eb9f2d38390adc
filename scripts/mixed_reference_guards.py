"""What mgf_tpu's own mixed sphere/capsule pile does while it collapses: the
reference numbers behind the guards that chip_smoke.py [11] holds the
PyTorch port to.  With ``--capsules NUM`` it steps the capsules demo
``capsules_scene(NUM)`` instead (the reference beside chip_smoke.py [13]);
with ``--balls sequential|parallel`` the 1,332-ball demo on the flat
reference solvers (chip_smoke.py [15] and [16]: the sequential one with the
reference's raw-lambda friction, the parallel one with the demo's default);
with ``--terrain N`` the heightfield scene ``terrain_scene(N)``
(chip_smoke.py [17]).

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

Takes about 0.5 s per step at 8,000 bodies and 1.7 s at 30,000 on 8 CPU
cores, after a 20-40 s compile; the capsules demo about 8 min at NUM = 5
for 416 steps and over 40 min at NUM = 11.  The balls demo and the terrain
scene print their step time.  Imports the JAX package only: nothing of the
port.
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
    args = ap.parse_args()

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


if __name__ == "__main__":
    main()

"""What mgf_tpu's own mixed sphere/capsule pile does while it collapses: the
reference numbers behind the guards that chip_smoke.py [11] holds the
PyTorch port to.  With ``--capsules NUM`` it steps the capsules demo
``capsules_scene(NUM)`` instead (the reference beside chip_smoke.py [13]).

Steps ``mgf_tpu.scenes.stress_scene(--bodies, mixed=True)`` with the JAX
package on the CPU for ``--steps`` steps from the initial block and prints
max penetration at step 128, at the last step and at its peak, the per-step
bucket overflow (the bodies the fat grid drops from full buckets: cell 2.0,
cap 14), the worst step's share of the bodies, and the count of bodies below
y = -1 or outside the walls.

    JAX_PLATFORMS=cpu python scripts/mixed_reference_guards.py --bodies 8000
    JAX_PLATFORMS=cpu python scripts/mixed_reference_guards.py --capsules 5 \
        --steps 416

Takes about 0.5 s per step at 8,000 bodies and 1.7 s at 30,000 on 8 CPU
cores, after a 20-40 s compile; the capsules demo about 8 min at NUM = 5
for 416 steps and over 40 min at NUM = 11.  Imports the JAX package only:
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
    args = ap.parse_args()

    import jax
    from mgf_tpu.scenes import capsules_scene, stress_scene
    from mgf_tpu.world import step

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


if __name__ == "__main__":
    main()

"""Headless "balls" demo on mgf_tpu_torch (PyTorch on a CUDA card): the
reference's mgf_demo/balls.rs scene, as demos/balls.py runs it on
mgf_tpu.

11^3 + 1 spheres (r = 0.5, mass 1, restitution 0.3, friction 0.6) dropped
into the open-top box terrain, dt = 1/60, 20 solver iterations, the pair
contact in the hand-written CUDA kernel K2; prints per-step wall-clock ms
like balls.rs:107-112 (no GL window: the physics is the demo), and at
the end the kernel launches.

    python demos/balls_torch.py [--steps 600] [--num 11] [--save out.npz]
        [--render frame.ppm] [--device cuda|cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--num", type=int, default=11)
    ap.add_argument("--solver", default="rows",
                    choices=["rows", "parallel", "sequential"])
    ap.add_argument("--save", default=None,
                    help="save the trajectory (positions per frame) to .npz")
    ap.add_argument("--render", default=None,
                    help="render the final frame to a .ppm image")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the world (default: the card)")
    args = ap.parse_args()

    from mgf_tpu_torch import world_from_numpy, world_to_numpy
    from mgf_tpu_torch.scenes import balls_scene
    from mgf_tpu_torch.world import make_step_fn

    world, cfg = balls_scene(num=args.num, solver=args.solver,
                             device=args.device)
    # the pair contact through kernel K2 (its plain version on CPU tensors)
    cfg = cfg._replace(pallas_narrowphase=True)
    step = make_step_fn(cfg)
    print(f"balls: {world.bodies.n_bodies} spheres, dt=1/60, "
          f"{cfg.solver_iters} solver iters, solver={cfg.solver}, "
          f"device={args.device}")

    t0 = time.perf_counter()
    world, metrics = step(world)
    _sync(args.device)
    print(f"first step (compile): {time.perf_counter() - t0:.1f}s")

    frames = []
    for i in range(args.steps):
        t0 = time.perf_counter()
        world, metrics = step(world)
        _sync(args.device)
        ms = (time.perf_counter() - t0) * 1000
        print(f"Physics step elapsed, took {ms:.2f} ms  "
              f"(contacts={int(metrics['num_contacts'])})", end="\r")
        if args.save:
            frames.append(np.stack([c.cpu().numpy() for c in world.bodies.x],
                                   axis=-1))
    print()
    from mgf_tpu_torch.ops import narrowphase, sequential_solve, solver_sweep
    print(f"hand-written kernel launches: K1 {solver_sweep.LAUNCHES}, K2 "
          f"{narrowphase.LAUNCHES}, K4 {sequential_solve.LAUNCHES}")
    y = world.bodies.x.y.cpu().numpy()
    print(f"done: y range [{y.min():.2f}, {y.max():.2f}]")
    if args.save:
        np.savez_compressed(args.save, x=np.stack(frames))
        print(f"saved trajectory to {args.save}")
    if args.render:
        from render import render_world
        # render.py reads every field with np.asarray: give it host tensors
        render_world(world_from_numpy(world_to_numpy(world), "cpu"),
                     path=args.render)
        print(f"rendered final frame to {args.render}")


if __name__ == "__main__":
    main()

"""Headless "capsules" demo on mgf_tpu_torch (PyTorch on a CUDA card): the
reference's mgf_demo/capsules.rs scene, as demos/capsules.py runs it on
mgf_tpu.

11^3 capsules (a=(-0.5,0,0), d=(1,0,0), r=1) on the box terrain,
dt = 1/60, 20 solver iterations; per-step wall-clock print per
capsules.rs:106-111.

    python demos/capsules_torch.py [--steps 300] [--num 11]
        [--render frame.ppm] [--device cuda|cpu]

The frame is drawn with demos/render.py's camera and rasterizer, as its
``render_world`` composes them; the capsule segments come from this
package's colliders (``render_world`` reads them through the JAX
package).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch


def render_capsule_world(world, width=640, height=480, path=None):
    """Render a host (CPU) mgf_tpu_torch World the way render.py's
    ``render_world`` does (world.rs:296-392): the camera 40 behind and 6
    above the bodies' mean, the terrain triangles, spheres as discs and
    capsules as swept sphere samples.  Returns the Frame."""
    from render import (Camera, Frame, draw_capsules, draw_spheres,
                        draw_triangles, save_ppm, view_proj)
    from mgf_tpu_torch.physics import colliders
    from mgf_tpu_torch.world import shape_view

    b = world.bodies
    vec = lambda v: np.stack([v.x.numpy(), v.y.numpy(), v.z.numpy()], 1)
    x = vec(b.x)
    target = x.mean(axis=0)
    camera = Camera(pos=(target[0], target[1] + 6.0, target[2] + 40.0),
                    yaw=0.0, pitch=-0.15)
    frame = Frame(width, height)
    mvp = view_proj(camera, width, height)
    t = world.terrain
    corners = [vec(p) for p in (t.a, t.b, t.c)]
    n_tris = corners[0].shape[0]
    verts = np.stack(corners, 1).reshape(-1, 3).astype(np.float64)
    draw_triangles(frame, mvp, verts, np.arange(3 * n_tris).reshape(-1, 3))
    st = b.shape_type.numpy()
    r = b.shape_r.numpy().astype(np.float64)
    if (st == 0).any():
        draw_spheres(frame, mvp, x[st == 0], r[st == 0])
    if (st == 1).any():
        _, caps = colliders(shape_view(b))
        draw_capsules(frame, mvp, vec(caps.a)[st == 1], vec(caps.d)[st == 1],
                      r[st == 1])
    if path:
        save_ppm(path, frame)
    return frame


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--num", type=int, default=11)
    ap.add_argument("--render", default=None,
                    help="render the final frame to a .ppm image")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the world (default: the card)")
    args = ap.parse_args()

    from mgf_tpu_torch import world_from_numpy, world_to_numpy
    from mgf_tpu_torch.scenes import capsules_scene
    from mgf_tpu_torch.world import make_step_fn

    world, cfg = capsules_scene(num=args.num, device=args.device)
    step = make_step_fn(cfg)
    print(f"capsules: {world.bodies.n_bodies} capsules, dt=1/60, "
          f"{cfg.solver_iters} solver iters, device={args.device}")

    t0 = time.perf_counter()
    world, metrics = step(world)
    _sync(args.device)
    print(f"first step (compile): {time.perf_counter() - t0:.1f}s")

    for i in range(args.steps):
        t0 = time.perf_counter()
        world, metrics = step(world)
        _sync(args.device)
        ms = (time.perf_counter() - t0) * 1000
        print(f"Physics step elapsed, took {ms:.2f} ms  "
              f"(contacts={int(metrics['num_contacts'])})", end="\r")
    print()
    from mgf_tpu_torch.ops import narrowphase, sequential_solve, solver_sweep
    print(f"hand-written kernel launches: K1 {solver_sweep.LAUNCHES}, K2 "
          f"{narrowphase.LAUNCHES}, K4 {sequential_solve.LAUNCHES}")
    y = world.bodies.x.y.cpu().numpy()
    print(f"done: y range [{y.min():.2f}, {y.max():.2f}]")
    if args.render:
        render_capsule_world(world_from_numpy(world_to_numpy(world), "cpu"),
                             path=args.render)
        print(f"rendered final frame to {args.render}")


if __name__ == "__main__":
    main()

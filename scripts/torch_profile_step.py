"""Where the time goes in one mgf_tpu_torch step on a CUDA card.

``--scene`` picks the path:

* ``flagship`` (default): ``stress_scene(--bodies)`` on the fused_iso
  branch through ``AdaptiveChunkStepper``;
* ``cold20``: the same pile on the generic branch with the reference's
  solver schedule (warm starting off, 20 two-phase sweeps, kernel K2 on;
  bench.py's ``stress_cold20`` row);
* ``balls``: the demo ``balls_scene(11)`` (1,332 bodies, K2 on);
* ``mixed``: ``stress_scene(--bodies, mixed=True)``, the sphere/capsule pile
  on the generic branch (type-partitioned narrowphase, two chained block
  solves, no hand-written kernel) through ``AdaptiveChunkStepper``;
* ``capsules``: the demo ``capsules_scene(11)`` (1,331 capsules, 20
  two-phase sweeps with Mat3 inertia);
* ``balls_seq`` / ``balls_par``: the demo on the reference's flat solvers,
  ``solver="sequential"`` with its raw-lambda friction (kernel K4, one
  launch per step) and ``solver="parallel"`` (mass-split Jacobi), both with
  K2 on;
* ``terrain``: ``terrain_scene(--bodies, default 10,000)``, spheres and
  capsules raining onto the 10,368-face heightfield (the face-grid cull,
  ``solver_rows=14``; no hand-written kernel).

Steps the scene in chunks of ``--chunk`` (light interior metrics) for
``--warmup`` steps, times ``--steps`` more with the host clock
(synchronised per chunk), then traces one more chunk with
``torch.profiler`` and prints: steps/s, device busy share of the traced
window (sum of kernel times over wall time), device operations per step,
the K1, K2 and K4 shares, and the top kernels by device time.  The full table
goes to ``--out``.

    python3 scripts/torch_profile_step.py --bodies 100000 --warmup 600
    python3 scripts/torch_profile_step.py --scene cold20 --warmup 180
    python3 scripts/torch_profile_step.py --scene mixed
    python3 scripts/torch_profile_step.py --scene balls_seq --steps 64
    python3 scripts/torch_profile_step.py --scene terrain --warmup 160

Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from mgf_tpu_torch.driver import (  # noqa: E402
    AdaptiveChunkStepper, make_chunk_step,
)
from mgf_tpu_torch.ops import (  # noqa: E402
    narrowphase, sequential_solve, solver_sweep,
)
from mgf_tpu_torch.scenes import (  # noqa: E402
    balls_scene, capsules_scene, stress_scene, terrain_scene,
)

WARMUP = {"flagship": 600, "cold20": 180, "balls": 280, "mixed": 256,
          "capsules": 280, "balls_seq": 280, "balls_par": 280,
          "terrain": 160}


class _Plain:
    """Fixed-schedule chunks with the AdaptiveChunkStepper interface."""

    def __init__(self, cfg, chunk):
        self.run = make_chunk_step(cfg, light=True)
        self.chunk = chunk
        self.hot_on = False

    def step_chunk(self, world):
        return self.run(world, torch.ones((self.chunk,), device="cuda"))


def _stepper(scene, bodies, chunk):
    if scene == "balls":
        world, cfg = balls_scene(11)
        return world, _Plain(cfg._replace(pallas_narrowphase=True), chunk)
    if scene in ("balls_seq", "balls_par"):
        seq = scene == "balls_seq"
        world, cfg = balls_scene(11, solver="sequential" if seq
                                 else "parallel")
        cfg = cfg._replace(pallas_narrowphase=True,
                           friction_mode="mgf" if seq else cfg.friction_mode)
        return world, _Plain(cfg, chunk)
    if scene == "terrain":
        world, cfg = terrain_scene(bodies or 10_000)
        return world, _Plain(cfg, chunk)
    if scene == "capsules":
        world, cfg = capsules_scene(11)
        return world, _Plain(cfg, chunk)
    bodies = bodies or 100_000
    if scene == "mixed":
        world, cfg = stress_scene(bodies, mixed=True)
        return world, AdaptiveChunkStepper(cfg, chunk=chunk, light=True)
    world, cfg = stress_scene(bodies)
    if scene == "flagship":
        return world, AdaptiveChunkStepper(cfg, chunk=chunk, light=True)
    cfg = cfg._replace(warm_start=False, fused_iso=False,
                       warm_match="search", adapt_schedule=None,
                       solver_iters=20, solver_inner=1, two_phase=True,
                       pallas_narrowphase=True)
    return world._replace(warm=None), _Plain(cfg, chunk)


class _Guards:
    """The physics guards over every step run so far: the worst bucket
    overflow and the first step that had any, the worst cache drift excess,
    the deepest penetration among the steps that report it (the last of
    each chunk), and at the end the bodies more than 1 below the terrain's
    lowest point or outside its x/z extent."""

    def __init__(self):
        self.steps, self.over, self.first, self.drift = 0, 0, None, 0.0
        self.pen, self.pen_step = 0.0, 0

    def add(self, m):
        over = m["broadphase_overflow"].tolist()
        if self.first is None and any(over):
            self.first = self.steps + 1 + next(
                i for i, o in enumerate(over) if o)
        self.over = max(self.over, max(over))
        self.drift = max(self.drift,
                         float(m["broadphase_cache_drift_excess"].max()))
        self.steps += len(over)
        pen = float(m["max_penetration"][-1])
        if pen > self.pen:
            self.pen, self.pen_step = pen, self.steps

    def line(self, world):
        b, t = world.bodies, world.terrain
        wall = max(float(c.abs().max()) for v in t for c in (v.x, v.z))
        floor = min(float(v.y.min()) for v in t) - 1.0
        out = (b.x.y < floor) | (b.x.x.abs() > wall) | (b.x.z.abs() > wall)
        return (f"guards over {self.steps} steps: overflow worst step "
                f"{self.over} (first at step {self.first}), drift excess "
                f"{self.drift}, deepest chunk-end penetration {self.pen:.4f} "
                f"(step {self.pen_step}), escaped bodies {int(out.sum())}")


def _dev_time(ev):
    for k in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(ev, k):
            return getattr(ev, k)
    return 0.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", choices=sorted(WARMUP), default="flagship")
    ap.add_argument("--bodies", type=int, default=None,
                    help="bodies of the piles (default 100,000) and of "
                         "the terrain scene (default 10,000)")
    ap.add_argument("--warmup", type=int, default=None,
                    help="steps before timing (default: 600 flagship, "
                         "180 cold20, 280 balls, balls_seq, balls_par and "
                         "capsules, 256 mixed, 160 terrain)")
    ap.add_argument("--steps", type=int, default=128)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--out", default="build/profile_torch.txt")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"device: {smi}")
    warmup = WARMUP[args.scene] if args.warmup is None else args.warmup
    world, st = _stepper(args.scene, args.bodies, args.chunk)
    guards = _Guards()
    t0 = time.perf_counter()
    for _ in range(-(-warmup // args.chunk)):
        world, m = st.step_chunk(world)
        guards.add(m)
    torch.cuda.synchronize()
    print(f"scene {args.scene}, {world.bodies.n_bodies} bodies; warmup "
          f"{warmup} steps: {time.perf_counter() - t0:.2f} s")

    n_chunks = max(args.steps // args.chunk, 1)
    rebuilds, t_run = 0, 0.0
    for _ in range(n_chunks):
        t0 = time.perf_counter()
        world, m = st.step_chunk(world)
        torch.cuda.synchronize()
        t_run += time.perf_counter() - t0
        rebuilds += int(m["broadphase_rebuilt"].sum())
        guards.add(m)
    steps = n_chunks * args.chunk
    last = {k: float(v[-1]) for k, v in m.items()}
    print(f"timed {steps} steps: {steps / t_run:.2f} steps/s, "
          f"{1e3 * t_run / steps:.2f} ms/step, rebuilds {rebuilds}, "
          f"hot schedule {st.hot_on}, contacts {int(last['num_contacts'])}, "
          f"max pen {last['max_penetration']:.4f}, warm_hit "
          f"{last['warm_hit_frac']:.4f}, overflow "
          f"{int(last['broadphase_overflow'])}")
    print(guards.line(world))

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    solver_sweep.LAUNCHES = 0
    narrowphase.LAUNCHES = 0
    sequential_solve.LAUNCHES = 0
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        world, m = st.step_chunk(world)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rebuilt = int(m["broadphase_rebuilt"].sum())
    kernels = [e for e in prof.events()
               if getattr(e, "device_type", None) == torch.autograd
               .DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    share = lambda tag: sum(e.time_range.elapsed_us() for e in kernels
                            if tag in e.name)
    k1_us, k2_us = share("solver_sweep"), share("sphere_contact")
    k4_us = share("sequential_solve")
    print(f"traced {args.chunk} steps ({rebuilt} rebuilds): wall "
          f"{1e3 * wall:.1f} ms, device busy {busy_us / 1e3:.1f} ms "
          f"({100.0 * busy_us / (1e6 * wall):.1f}% busy), "
          f"{len(kernels) / args.chunk:.0f} device operations/step, K1 "
          f"{k1_us / 1e3:.2f} ms ({solver_sweep.LAUNCHES} launches, "
          f"{100.0 * k1_us / max(busy_us, 1):.1f}% of device time), K2 "
          f"{k2_us / 1e3:.2f} ms ({narrowphase.LAUNCHES} launches, "
          f"{100.0 * k2_us / max(busy_us, 1):.1f}% of device time), K4 "
          f"{k4_us / 1e3:.2f} ms ({sequential_solve.LAUNCHES} launches, "
          f"{100.0 * k4_us / max(busy_us, 1):.1f}% of device time)")
    table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=40)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(f"device: {smi}\n{table}\n")
    top = sorted(prof.key_averages(), key=_dev_time, reverse=True)[:12]
    for ev in top:
        print(f"  {_dev_time(ev) / 1e3:9.2f} ms  {ev.count:6d}x  "
              f"{ev.key[:90]}")


if __name__ == "__main__":
    main()

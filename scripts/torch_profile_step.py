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
``--warmup`` steps with the program's tracing on, then, for the captured
step (the chunk driver's default: CUDA graphs of the step replayed,
``graphs.CapturedStep``, on the paths it covers) and after it for the
eager one (the same stepper switched to ``capture=False``): times
``--steps`` more with the host clock (synchronised per chunk) and prints
steps/s and the program's stage table over those steps
(``tracing.summary``: device ms a step by stage and layer, idle share,
the host's wait on ``need``, counters); then traces one more chunk with
``torch.profiler`` and prints device operations and graph launches per
step, the K1, K2 and K4 launches and the top kernels by device time.  The
full tables go to ``--out``.

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

from mgf_tpu_torch import tracing  # noqa: E402
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
        self.run_chunk = make_chunk_step(cfg, light=True)
        self.chunk = chunk
        self.hot_on = False

    def step_chunk(self, world):
        return self.run_chunk(world, torch.ones((self.chunk,),
                                                device="cuda"))


def _scene(scene, bodies):
    """(world, cfg) of ``scene``."""
    if scene == "balls":
        world, cfg = balls_scene(11)
        return world, cfg._replace(pallas_narrowphase=True)
    if scene in ("balls_seq", "balls_par"):
        seq = scene == "balls_seq"
        world, cfg = balls_scene(11, solver="sequential" if seq
                                 else "parallel")
        return world, cfg._replace(
            pallas_narrowphase=True,
            friction_mode="mgf" if seq else cfg.friction_mode)
    if scene == "terrain":
        return terrain_scene(bodies or 10_000)
    if scene == "capsules":
        return capsules_scene(11)
    bodies = bodies or 100_000
    if scene == "mixed":
        return stress_scene(bodies, mixed=True)
    world, cfg = stress_scene(bodies)
    if scene == "flagship":
        return world, cfg
    cfg = cfg._replace(warm_start=False, fused_iso=False,
                       warm_match="search", adapt_schedule=None,
                       solver_iters=20, solver_inner=1, two_phase=True,
                       pallas_narrowphase=True)
    return world._replace(warm=None), cfg


def _stepper(cfg, chunk):
    """The scene's chunk stepper."""
    if cfg.adapt_schedule is None:
        return _Plain(cfg, chunk)
    return AdaptiveChunkStepper(cfg, chunk=chunk, light=True)


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


def _stage_line(label, rec):
    """The program's stage table of ``rec`` (``tracing.record()``): device
    ms a step by stage, then by layer, the idle share, the host's wait on
    ``need`` and the counters."""
    t = tracing.summary(rec)
    fmt = lambda d: ", ".join(f"{k} {v:.3f}" for k, v in d.items()
                              if not isinstance(v, dict) and v is not None)
    return (f"{label}: {t['steps']} stamped steps, device ms a step: "
            f"{fmt(t['stages'])}; {fmt(t)}; {rec['counters']}, schedules "
            f"{rec['schedules']}")


def _measure(label, st, world, guards, args):
    """Time ``--steps`` steps of ``st`` from ``world`` and print the stage
    table of those steps, then trace one more chunk; returns (the world,
    the traced table)."""
    n_chunks = max(args.steps // args.chunk, 1)
    rebuilds, t_run = 0, 0.0
    cap = st.run_chunk.captured
    graphs = cap.n_graphs if cap is not None else 0
    torch.cuda.synchronize()
    tracing.reset()
    for _ in range(n_chunks):
        t0 = time.perf_counter()
        world, m = st.step_chunk(world)
        torch.cuda.synchronize()
        t_run += time.perf_counter() - t0
        rebuilds += int(m["broadphase_rebuilt"].sum())
        guards.add(m)
    rec = tracing.record()
    steps = n_chunks * args.chunk
    last = {k: float(v[-1]) for k, v in m.items()}
    print(f"{label}: timed {steps} steps: {steps / t_run:.2f} steps/s, "
          f"{1e3 * t_run / steps:.2f} ms/step, rebuilds {rebuilds}, "
          f"hot schedule {st.hot_on}, contacts {int(last['num_contacts'])}, "
          f"max pen {last['max_penetration']:.4f}, warm_hit "
          f"{last['warm_hit_frac']:.4f}, overflow "
          f"{int(last['broadphase_overflow'])}")
    line = _stage_line(label, rec)
    if cap is not None and cap.n_graphs > graphs:
        line += (f" ({cap.n_graphs - graphs} graph(s) captured in these "
                 "steps: the captures' host time is in the table)")
    print(line)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    solver_sweep.LAUNCHES = 0
    narrowphase.LAUNCHES = 0
    sequential_solve.LAUNCHES = 0
    replays = cap.replays if cap is not None else 0
    with torch.profiler.profile(activities=acts) as prof:
        world, m = st.step_chunk(world)
        torch.cuda.synchronize()
    replays = (cap.replays if cap is not None else 0) - replays
    ops = sum(1 for e in prof.events()
              if getattr(e, "device_type", None)
              == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False))
    print(f"{label}: traced {args.chunk} steps: {ops / args.chunk:.0f} "
          f"device operations/step (stamps included), "
          f"{replays / args.chunk:.2f} graph launches/step, launches K1 "
          f"{solver_sweep.LAUNCHES}, K2 {narrowphase.LAUNCHES}, K4 "
          f"{sequential_solve.LAUNCHES}")
    top = sorted(prof.key_averages(), key=_dev_time, reverse=True)[:12]
    for ev in top:
        print(f"  {_dev_time(ev) / 1e3:9.2f} ms  {ev.count:6d}x  "
              f"{ev.key[:90]}")
    return world, line + "\n" + prof.key_averages().table(
        sort_by="self_cuda_time_total", row_limit=40)


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
    tracing.enable("cuda")      # before the graphs are captured
    world, cfg = _scene(args.scene, args.bodies)
    st = _stepper(cfg, args.chunk)
    guards = _Guards()
    t0 = time.perf_counter()
    for _ in range(-(-warmup // args.chunk)):
        world, m = st.step_chunk(world)
        guards.add(m)
    torch.cuda.synchronize()
    cap = st.run_chunk.captured
    print(f"scene {args.scene}, {world.bodies.n_bodies} bodies; warmup "
          f"{warmup} steps: {time.perf_counter() - t0:.2f} s; "
          + (f"captured: {cap.n_graphs} graphs, capture "
             f"{cap.capture_seconds:.2f} s, graph memory "
             f"{cap.graph_bytes / 2**20:.1f} MiB reserved"
             if cap is not None else "eager (no graph on this path)"))
    world, table = _measure("captured" if cap is not None else "default",
                            st, world, guards, args)
    tables = [table]
    if cap is not None:
        # the same stepper and schedule state, stepped eagerly from here
        st.run_chunk.capture = False
        world, table = _measure("eager", st, world, guards, args)
        tables.append(table)
    print(guards.line(world))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(f"device: {smi}\n" + "\n".join(tables) + "\n")


if __name__ == "__main__":
    main()

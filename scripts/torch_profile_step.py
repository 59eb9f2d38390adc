"""Where the time goes in one mgf_tpu_torch flagship step on a CUDA card.

Steps ``stress_scene(--bodies)`` through ``AdaptiveChunkStepper`` (chunk 16,
light interior metrics) for ``--warmup`` steps, times ``--steps`` more with
the host clock (synchronised per chunk), then traces one more window with
``torch.profiler`` and prints: steps/s, device busy share of the traced
window (sum of kernel times over wall time), kernel launches per step, the
K1 share, and the top kernels by device time.  The full table goes to
``--out``.

    python3 scripts/torch_profile_step.py --bodies 100000 --warmup 600

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

from mgf_tpu_torch.driver import AdaptiveChunkStepper  # noqa: E402
from mgf_tpu_torch.ops import solver_sweep  # noqa: E402
from mgf_tpu_torch.scenes import stress_scene  # noqa: E402


def _dev_time(ev):
    for k in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(ev, k):
            return getattr(ev, k)
    return 0.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bodies", type=int, default=100_000)
    ap.add_argument("--warmup", type=int, default=600)
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
    world, cfg = stress_scene(args.bodies, device="cuda")
    st = AdaptiveChunkStepper(cfg, chunk=args.chunk, light=True)
    t0 = time.perf_counter()
    world, m = st.run(world, args.warmup)
    torch.cuda.synchronize()
    print(f"warmup {args.warmup} steps: {time.perf_counter() - t0:.2f} s")

    n_chunks = max(args.steps // args.chunk, 1)
    rebuilds, t_run = 0, 0.0
    for _ in range(n_chunks):
        t0 = time.perf_counter()
        world, m = st.step_chunk(world)
        torch.cuda.synchronize()
        t_run += time.perf_counter() - t0
        rebuilds += int(m["broadphase_rebuilt"].sum())
    steps = n_chunks * args.chunk
    last = {k: float(v[-1]) for k, v in m.items()}
    print(f"timed {steps} steps: {steps / t_run:.2f} steps/s, "
          f"{1e3 * t_run / steps:.2f} ms/step, rebuilds {rebuilds}, "
          f"hot schedule {st.hot_on}, contacts {int(last['num_contacts'])}, "
          f"max pen {last['max_penetration']:.4f}, warm_hit "
          f"{last['warm_hit_frac']:.4f}, overflow "
          f"{int(last['broadphase_overflow'])}")

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    solver_sweep.LAUNCHES = 0
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
    k1_us = sum(e.time_range.elapsed_us() for e in kernels
                if "solver_sweep" in e.name)
    print(f"traced {args.chunk} steps ({rebuilt} rebuilds): wall "
          f"{1e3 * wall:.1f} ms, device busy {busy_us / 1e3:.1f} ms "
          f"({100.0 * busy_us / (1e6 * wall):.1f}% busy), "
          f"{len(kernels) / args.chunk:.0f} kernels/step, K1 "
          f"{k1_us / 1e3:.2f} ms ({solver_sweep.LAUNCHES} launches)")
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

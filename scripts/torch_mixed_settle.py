"""The mixed pile's settle check on the port: stress_scene(n, mixed=True)
(a quarter of the bodies capsules) stepped one step per call on its own
config (the adaptive schedule in the step), printing every ``--every``
steps: mean |v| and mean |omega| over the bodies, the bodies escaped
(below y = -1 or outside the walls), contacts, bucket overflow, and the
max and p99 penetration (``bench_torch._penetration_p99``, one
``collect_contacts`` step whose state is dropped).  The card's name and
power limit come first; each line also gives the steps/s since the last.

    python3 scripts/torch_mixed_settle.py [--bodies 10000] [--steps 600]
                                          [--every 120] [--device cuda]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import torch  # noqa: E402

from bench_torch import (  # noqa: E402
    _penetration_p99, card_line, escaped_bodies,
)


def mean_norm(v):
    return float(torch.sqrt(v.x * v.x + v.y * v.y + v.z * v.z).mean())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bodies", type=int, default=10_000)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--every", type=int, default=120)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        sys.exit("torch_mixed_settle: no CUDA device")
    from mgf_tpu_torch.scenes import stress_scene
    from mgf_tpu_torch.world import step

    print(card_line(dev), flush=True)
    world, cfg = stress_scene(args.bodies, mixed=True, device=dev)
    t0 = time.perf_counter()
    for s in range(1, args.steps + 1):
        world, m = step(world, cfg)
        if s % args.every == 0:
            b = world.bodies
            rate = args.every / (time.perf_counter() - t0)
            print(f"step {s}: mean |v| {mean_norm(b.v):.4f}, mean |omega| "
                  f"{mean_norm(b.omega):.4f}, escaped "
                  f"{escaped_bodies(world)}, contacts {int(m['num_contacts'])}, overflow "
                  f"{int(m['broadphase_overflow'])}, max penetration "
                  f"{float(m['max_penetration']):.4f}, p99 penetration "
                  f"{_penetration_p99(world, cfg):.4f}, drift excess "
                  f"{float(m['broadphase_cache_drift_excess'])}, "
                  f"warm_hit_frac {float(m['warm_hit_frac']):.4f} "
                  f"({rate:.2f} steps/s)", flush=True)
            t0 = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())

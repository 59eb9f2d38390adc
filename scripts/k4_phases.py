"""Where the time goes inside kernel K4 (the level-by-level sequential
Gauss-Seidel solve, ``mgf_tpu_torch/ops/csrc/sequential_solve.cu``) on a
CUDA card.  ``ncu`` and ``nsys`` do not run everywhere, so the script reads
the SM clock from inside the kernel instead: it writes a copy of the source
with ``clock64()`` stamps of thread 0 at the phase boundaries (the source's
own phase comments are the anchors) and, with ``--levels``, before and after
each level step's update and before its barrier; builds the copy with the
package's nvcc flags; and runs it on the constraint list of the demo
``balls_scene(11, solver="sequential")`` with the reference's raw-lambda
friction after ``--steps`` steps (``chip_smoke.py`` [14]'s list after [15]).

Prints the card's name and power limit; the production kernel's time (CUDA
events, median of 5 blocks of 20 calls) at 0, 1 and the list's sweeps, so
the sweeps' share follows from the difference; that the stamped copy's
output equals the production kernel's bit for bit; the cycles of each
phase (count + scan of the valid flags, the static keys, issuing the body
copies, the points' slots, their bodies, the schedule's rounds, staging in
level order, the sweeps); the levels a sweep and their widths; and with
``--levels`` thread 0's mean cycles per level step in the update, the
fetch of its next point, and the barrier.

    python3 scripts/k4_phases.py --levels

Needs a CUDA card and nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from mgf_tpu_torch.ops import _build  # noqa: E402
from mgf_tpu_torch.ops import sequential_solve as seq  # noqa: E402

SRC = ROOT / "mgf_tpu_torch" / "ops" / "csrc" / "sequential_solve.cu"
STAMPS = 512
STAMP_DEFS = f"""
__device__ long long g_stamps[{STAMPS}];
#define STAMP(i) do {{ if (threadIdx.x == 0 && (i) < {STAMPS}) \\
    g_stamps[i] = clock64(); }} while (0)
"""
EXPORT = f"""
extern "C" int k4_stamps(long long* host) {{
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_stamps,
                                               {STAMPS} * sizeof(long long)));
}}
"""
# (phase name, the source text the stamp goes before); stamp 0 after the
# kernel's first line, the last before the copy-out
PHASES = [
    ("count + scan of the valid flags", "  if (bodies_in_smem &&\n"),
    ("static keys", "  // the body table, in flight"),
    ("issuing the body copies", "  // the valid points' slots in order"),
    ("the points' slots", "  // and their bodies"),
    ("their bodies", "  // the schedule, in rounds."),
    ("the schedule's rounds", "  // level order for what the sweeps read"),
    ("staging in level order", "  // the sweeps, level by level"),
    ("the sweeps",
     "\n  if constexpr (kShared)\n    for (int j = tid; j < kBodyFloats * M;"),
]
FIRST = "  int phase = 0, nv;\n"
LEVEL_STEPS = 160    # level steps stamped with --levels (3 stamps each)
LEVEL_BASE = 16
LEVEL_ANCHORS = [
    ("    if (p < hi) run(item);\n",
     "    STAMP({b} + 3 * s);\n    if (p < hi) run(item);\n"
     "    STAMP({b} + 1 + 3 * s);\n"),
    ("    if (nlo + tid < nhi) fetch(nlo + tid, item);\n"
     "    __syncthreads();\n",
     "    if (nlo + tid < nhi) fetch(nlo + tid, item);\n"
     "    STAMP({b} + 2 + 3 * s);\n    __syncthreads();\n"),
]


def _insert(src, anchor, new):
    if src.count(anchor) != 1:
        raise RuntimeError(f"anchor not found once in {SRC.name}: {anchor!r}")
    return src.replace(anchor, new)


def stamped_source(levels):
    src = _insert(SRC.read_text(), "namespace {\n",
                  "namespace {\n" + STAMP_DEFS)
    src = _insert(src, FIRST, FIRST + "  STAMP(0);\n")
    for i, (_, anchor) in enumerate(PHASES, start=1):
        if anchor.startswith("\n"):
            src = _insert(src, anchor, f"\n  STAMP({i});" + anchor)
        else:
            src = _insert(src, anchor, f"  STAMP({i});\n" + anchor)
    if levels:
        for anchor, new in LEVEL_ANCHORS:
            src = _insert(src, anchor, new.format(b=LEVEL_BASE))
    return src + EXPORT


def build(levels):
    out = ROOT / "build" / "k4_phases"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / "stamped.cu", out / "libstamped.so"
    cu.write_text(stamped_source(levels))
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(cu)], check=True)
    lib = ctypes.CDLL(str(so))
    fn = lib.mgf_sequential_solve
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.k4_stamps.argtypes = [ctypes.c_void_p]
    lib.k4_stamps.restype = ctypes.c_int
    return lib, fn


def demo_list(steps):
    """K4's inputs after ``steps`` steps of the sequential demo."""
    from mgf_tpu_torch.driver import make_chunk_step
    from mgf_tpu_torch.scenes import balls_scene
    from mgf_tpu_torch.world import step
    world, cfg = balls_scene(11, solver="sequential", device="cuda")
    cfg = cfg._replace(pallas_narrowphase=True, friction_mode="mgf")
    chunk, ones = make_chunk_step(cfg, light=True), torch.ones(
        (20,), dtype=torch.float32, device="cuda")
    for _ in range(steps // 20):
        world = chunk(world, ones)[0]
    return seq.capture_inputs(lambda: step(world, cfg))[0]


def time_ms(fn, reps=20, blocks=5):
    for _ in range(reps):
        fn()
    times = []
    for _ in range(blocks):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return float(np.median(times))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=280)
    ap.add_argument("--levels", action="store_true",
                    help="also stamp each level step of thread 0")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k4_phases: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    _build.build_all()
    inp = demo_list(args.steps)
    run = lambda n: seq.sequential_solve(inp["pts"], inp["a"], inp["b"],
                                         inp["valid"], inp["bodies"], n,
                                         inp["mgf"])
    cpu = [inp[k].cpu() for k in ("a", "b", "valid", "bodies")]
    level = seq.sequential_schedule(*cpu)
    widths = torch.bincount(level[cpu[2]]).tolist()[1:]
    iters = inp["iters"]
    print(f"list: {inp['valid'].numel()} points, {int(cpu[2].sum())} valid, "
          f"{inp['bodies'].shape[0]} body rows, {iters} sweeps; "
          f"{len(widths)} levels a sweep, widths {widths}", flush=True)
    for n in (0, 1, iters):
        print(f"production K4, {n} sweeps: {time_ms(lambda: run(n)):.4f} ms",
              flush=True)
    ref = run(iters)
    lib, fn = build(args.levels)
    prod = seq._lib
    seq._lib = lambda: fn
    try:
        out = run(iters)
    finally:
        seq._lib = prod
    torch.cuda.synchronize()
    print(f"stamped copy equals the production kernel: "
          f"{torch.equal(out, ref)}", flush=True)
    buf = (ctypes.c_longlong * STAMPS)()
    if lib.k4_stamps(ctypes.addressof(buf)) != 0:
        raise RuntimeError("cudaMemcpyFromSymbol failed")
    st = list(buf)
    total = st[len(PHASES)] - st[0]
    for i, (name, _) in enumerate(PHASES):
        d = st[i + 1] - st[i]
        print(f"  {name}: {d} cycles ({100 * d / total:.1f} %)", flush=True)
    print(f"  total {total} cycles", flush=True)
    if args.levels:
        n = min(LEVEL_STEPS - 1, iters * len(widths) - 1)
        at = lambda s, j: st[LEVEL_BASE + 3 * s + j]
        run_c = [at(s, 1) - at(s, 0) for s in range(n)]
        fetch_c = [at(s, 2) - at(s, 1) for s in range(n)]
        bar_c = [at(s + 1, 0) - at(s, 2) for s in range(n)]
        print(f"  thread 0 per level step over {n} steps: update "
              f"{np.mean(run_c):.1f}, fetch {np.mean(fetch_c):.1f}, "
              f"barrier {np.mean(bar_c):.1f} cycles (mean)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

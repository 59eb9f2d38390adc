"""The comparison's control, on the card at a cell's own size.

    python3 physbench/control.py --workload <cell> --seconds 4 \
        --seeds 11 12 13 [--dtype bfloat16]

For each seed, in one process: a run of the cell as ``run.py`` makes it
(the program settles, runs a short window, and its compared chunks are
held against the float32 reference), and for the same chunks the
reference computed in the precision below the configuration's float32
(bfloat16; there is no matrix product for TF32 to touch) put in the
program's place.  One JSON line a seed: the program's readings (the
lower ones of each limit) and the control's (the upper ones).  The
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--dtype", default="bfloat16")
    args = ap.parse_args(argv)
    import torch
    from physbench import run
    from physbench.harness import manifest
    if not torch.cuda.is_available():
        print("physbench control: needs a CUDA card", file=sys.stderr)
        return 2
    cell = manifest.cell(args.workload)
    conf = manifest.config(cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    limits = manifest.limits(cell["name"])
    dtype = getattr(torch, args.dtype)
    for seed in args.seeds:
        t0 = time.perf_counter()
        res = run.run_cell(cell, conf, traffic, limits, seed, args.seconds,
                           False, torch.device("cuda"), t0,
                           control_dtype=dtype)
        print(json.dumps(dict(
            workload=args.workload, seed=seed, dtype=args.dtype,
            program={k: v["value"] for k, v in res["checks"].items()},
            control=res["control"], correct=res["correct"],
            seconds=time.perf_counter() - t0)), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

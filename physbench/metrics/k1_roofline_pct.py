"""Kernel K1's share of its roofline: the least time of the traced
launches' work (each launch's bytes and operations from the window's row
count R, bodies N, gathered rows K and inner sweeps, over the card's
published peaks: ``physbench/harness/roofline.py``) over K1's traced
device time.  Nothing to read where K1 does not run."""

LAYER = "kernels (ops/solver_sweep.py, solver_sweep.cu)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "steps_per_s"
READS = "the device trace, kernels named solver_sweep"


def read(ctx):
    k1 = ctx.get("k1")
    if not k1 or not k1["launches"] or not k1["time_s"]:
        return None
    return 100.0 * k1["bound_s"] / k1["time_s"]

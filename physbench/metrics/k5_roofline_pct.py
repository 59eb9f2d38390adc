"""Kernel K5's share of its roofline: the least time of the traced
launches' work (each launch's bytes and operations from the bodies, the
mesh's faces, the candidates a body and whether the step writes the deepest
penetration, over the card's published peaks:
``physbench/harness/roofline.py``) over K5's traced device time.  Nothing
to read where K5 does not run."""

LAYER = "kernels (ops/terrain.py, sphere_terrain.cu)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "steps_per_s"
READS = "the device trace, kernels named sphere_terrain"


def read(ctx):
    k5 = ctx.get("k5")
    if not k5 or not k5["launches"] or not k5["time_s"]:
        return None
    return 100.0 * k5["bound_s"] / k5["time_s"]

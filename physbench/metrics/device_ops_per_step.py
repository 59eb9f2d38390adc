"""Device operations (kernels, copies and sets) a step in the traced
window."""

LAYER = "step (world.py)"
UNIT = "ops/step"
SOURCE = "device_trace"
MOVES = "steps_per_s"
READS = "the device trace"


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr["steps"]:
        return None
    return tr["n_ops"] / tr["steps"]

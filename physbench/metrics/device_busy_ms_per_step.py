"""Device time a step: the union of the device operations' intervals in
the traced window, over its steps."""

LAYER = "step (world.py)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "steps_per_s"
READS = "the device trace"


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr["steps"]:
        return None
    return 1e3 * tr["busy_s"] / tr["steps"]

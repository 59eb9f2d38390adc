"""Broadphase candidate-list rebuilds a step in the window: the sum of
the step metric ``broadphase_rebuilt`` over the window's steps."""

LAYER = "broadphase (broadphase.py)"
UNIT = "rebuilds/step"
SOURCE = "program_counter"
MOVES = "frame_ms_p95"
READS = "the step metric broadphase_rebuilt"


def read(ctx):
    if ctx.get("rebuilds") is None or not ctx["steps"]:
        return None
    return ctx["rebuilds"] / ctx["steps"]

"""CUDA graph launches a step in the window: ``CapturedStep.replays``
counted over the window's steps."""

LAYER = "compiled chunk (graphs.py)"
UNIT = "launches/step"
SOURCE = "program_counter"
MOVES = "steps_per_s"
READS = "graphs.CapturedStep.replays"


def read(ctx):
    if ctx.get("replays") is None or not ctx["steps"]:
        return None
    return ctx["replays"] / ctx["steps"]

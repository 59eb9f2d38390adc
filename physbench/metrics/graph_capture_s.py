"""Seconds the program spent capturing the step's CUDA graphs during
set-up: ``CapturedStep.capture_seconds``."""

LAYER = "compiled chunk (graphs.py)"
UNIT = "s"
SOURCE = "program_span"
MOVES = "setup_s"
READS = "graphs.CapturedStep.capture_seconds"


def read(ctx):
    s = ctx.get("capture_s")
    return s if s else None

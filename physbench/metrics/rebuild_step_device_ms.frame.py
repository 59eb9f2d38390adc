"""Device time of a step that rebuilds the candidate lists: the head's
stamped intervals a step plus the rebuild tails' over the rebuilds (the
frame cell's slowest frames are these).

Read from the program's own tracing (``mgf_tpu_torch.tracing``) over the
steps a ``--trace 1`` run makes with it on: ``tracing.summary``'s
``rebuild_step``.  Nothing to read in a ``--trace 0`` run."""

LAYER = "broadphase (broadphase.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frame_ms_p95"
READS = "mgf_tpu_torch.tracing.summary: rebuild_step"


def read(ctx):
    prog = ctx.get("program")
    return prog["summary"].get("rebuild_step") if prog else None

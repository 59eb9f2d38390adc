"""Device idle time a step while the host reads ``need``: the stamped
interval ``need_gap``, from the head's end to the tail's first node.

Read from the program's own tracing (``mgf_tpu_torch.tracing``) over the
steps a ``--trace 1`` run makes with it on: ``tracing.summary``'s
``need_gap``.  Nothing to read in a ``--trace 0`` run."""

LAYER = "compiled chunk (graphs.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "steps_per_s"
READS = "mgf_tpu_torch.tracing.summary: need_gap"


def read(ctx):
    prog = ctx.get("program")
    return prog["summary"].get("need_gap") if prog else None

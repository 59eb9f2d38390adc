"""Host time a step blocked in the read of ``need`` between the head's and
the tail's graph (the program's span ``graphs.need_read``).

Read from the program's own tracing (``mgf_tpu_torch.tracing``) over the
steps a ``--trace 1`` run makes with it on: ``tracing.summary``'s
``need_wait``.  Nothing to read in a ``--trace 0`` run."""

LAYER = "compiled chunk (graphs.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "steps_per_s"
READS = "mgf_tpu_torch.tracing.summary: need_wait"


def read(ctx):
    prog = ctx.get("program")
    return prog["summary"].get("need_wait") if prog else None

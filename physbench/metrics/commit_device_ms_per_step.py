"""Device time a step committing the step into the chunk's static buffers:
the stamped interval ``finish``.

Read from the program's own tracing (``mgf_tpu_torch.tracing``) over the
steps a ``--trace 1`` run makes with it on: ``tracing.summary``'s
``commit``.  Nothing to read in a ``--trace 0`` run."""

LAYER = "compiled chunk (graphs.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "steps_per_s"
READS = "mgf_tpu_torch.tracing.summary: commit"


def read(ctx):
    prog = ctx.get("program")
    return prog["summary"].get("commit") if prog else None

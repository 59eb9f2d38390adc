"""Device time a step in the broadphase: the stamped intervals ``bounds``
and ``pairs`` (rebuild and reuse steps together).

Read from the program's own tracing (``mgf_tpu_torch.tracing``) over the
steps a ``--trace 1`` run makes with it on: ``tracing.summary``'s
``broadphase``.  Nothing to read in a ``--trace 0`` run."""

LAYER = "broadphase (broadphase.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "steps_per_s"
READS = "mgf_tpu_torch.tracing.summary: broadphase"


def read(ctx):
    prog = ctx.get("program")
    return prog["summary"].get("broadphase") if prog else None

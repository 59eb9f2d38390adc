"""Device time a step in the narrowphase: the stamped intervals ``narrow``
(pair contacts) and ``terrain`` (kernel K5 for spheres).

Read from the program's own tracing (``mgf_tpu_torch.tracing``) over the
steps a ``--trace 1`` run makes with it on: ``tracing.summary``'s
``narrowphase``.  Nothing to read in a ``--trace 0`` run."""

LAYER = "narrowphase (collision.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "steps_per_s"
READS = "mgf_tpu_torch.tracing.summary: narrowphase"


def read(ctx):
    prog = ctx.get("program")
    return prog["summary"].get("narrowphase") if prog else None

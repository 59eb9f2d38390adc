"""Device time a step building the rows, the constraint precompute and the
warm-start match: the stamped intervals ``rows``, ``constraints`` and
``warm``.

Read from the program's own tracing (``mgf_tpu_torch.tracing``) over the
steps a ``--trace 1`` run makes with it on: ``tracing.summary``'s
``constraints``.  Nothing to read in a ``--trace 0`` run."""

LAYER = "constraints (manifold.py, solver.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "steps_per_s"
READS = "mgf_tpu_torch.tracing.summary: constraints"


def read(ctx):
    prog = ctx.get("program")
    return prog["summary"].get("constraints") if prog else None

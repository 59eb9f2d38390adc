"""Device time a step in ``solve_rows`` (the warm pre-apply and K1's
sweeps): the stamped interval ``solve``.

Read from the program's own tracing (``mgf_tpu_torch.tracing``) over the
steps a ``--trace 1`` run makes with it on: ``tracing.summary``'s
``solver``.  Nothing to read in a ``--trace 0`` run."""

LAYER = "solver (solver.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "steps_per_s"
READS = "mgf_tpu_torch.tracing.summary: solver"


def read(ctx):
    prog = ctx.get("program")
    return prog["summary"].get("solver") if prog else None

"""Candidate pairs the narrowphase tested a step: the program's device
counter ``pairs_tested`` (the candidate rows' ``pair_ok``).

Read from the program's own tracing (``mgf_tpu_torch.tracing``) over the
steps a ``--trace 1`` run makes with it on: ``tracing.summary``'s
``pairs_tested_per_step``.  Nothing to read in a ``--trace 0`` run."""

LAYER = "narrowphase (collision.py)"
UNIT = "pairs/step"
SOURCE = "program_counter"
MOVES = "steps_per_s"
READS = "mgf_tpu_torch.tracing.summary: pairs_tested_per_step"


def read(ctx):
    prog = ctx.get("program")
    return prog["summary"].get("pairs_tested_per_step") if prog else None

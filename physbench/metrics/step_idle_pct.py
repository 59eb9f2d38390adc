"""The device's idle share of the stamped span: the intervals ``step_gap``
(before a step's head) and ``need_gap`` (while the host reads ``need``)
over the first stamp to the last.

Read from the program's own tracing (``mgf_tpu_torch.tracing``) over the
steps a ``--trace 1`` run makes with it on: ``tracing.summary``'s
``idle_pct``.  Nothing to read in a ``--trace 0`` run."""

LAYER = "device (H100)"
UNIT = "%"
SOURCE = "program_span"
MOVES = "steps_per_s"
READS = "mgf_tpu_torch.tracing.summary: idle_pct"


def read(ctx):
    prog = ctx.get("program")
    return prog["summary"].get("idle_pct") if prog else None

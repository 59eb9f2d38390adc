"""The share of the stamped steps that ran on the adaptive schedule's hot
(cheaper) solver schedule: ``AdaptiveChunkStepper.step_chunk``'s count of
steps a schedule.

Read from the program's own tracing (``mgf_tpu_torch.tracing``) over the
steps a ``--trace 1`` run makes with it on: ``tracing.summary``'s
``hot_schedule_pct``.  Nothing to read in a ``--trace 0`` run."""

LAYER = "driver (driver.py)"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "steps_per_s"
READS = "mgf_tpu_torch.tracing.summary: hot_schedule_pct"


def read(ctx):
    prog = ctx.get("program")
    return prog["summary"].get("hot_schedule_pct") if prog else None

"""Valid constraint rows a step in the capsule columns of the mixed pile
(bodies at and past ``n_sphere_rows``: capsule-sphere, capsule-capsule and
capsule-terrain contacts, up to two a pair): the program's device counter
``capsule_rows``, which the split solve's capsule block sweeps.

Read from the program's own tracing (``mgf_tpu_torch.tracing``) over the
steps a ``--trace 1`` run makes with it on: ``tracing.summary``'s
``capsule_rows_per_step``, None where no stamped step ran the split solve
(the sphere pile's fused step, or a program without the counter).
Nothing to read in a ``--trace 0`` run."""

LAYER = "narrowphase (collision.py)"
UNIT = "rows/step"
SOURCE = "program_counter"
MOVES = "steps_per_s"
READS = "mgf_tpu_torch.tracing.summary: capsule_rows_per_step"


def read(ctx):
    prog = ctx.get("program")
    return prog["summary"].get("capsule_rows_per_step") if prog else None

"""Device time a step in the split solve's capsule block (the mixed
pile's capsules: Mat3 inertia, every row, from the state the sphere block
left; the accumulators' assembly and the new warm rows): the stamped
interval ``solve_capsules``.

Read from the program's own tracing (``mgf_tpu_torch.tracing``) over the
steps a ``--trace 1`` run makes with it on: ``tracing.summary``'s
``capsule_block_solve``, None where no stamped step ran the split solve
(the sphere pile's fused step, or a program without the stamp).  Nothing
to read in a ``--trace 0`` run."""

LAYER = "solver (solver.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "steps_per_s"
READS = "mgf_tpu_torch.tracing.summary: capsule_block_solve"


def read(ctx):
    prog = ctx.get("program")
    return prog["summary"].get("capsule_block_solve") if prog else None

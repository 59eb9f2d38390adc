"""Device time a step in the split solve's sphere block (the mixed pile's
spheres: scalar inertia, their slot-0 pair and terrain rows, warm
pre-apply and sweeps): the stamped interval ``solve_spheres``.

Read from the program's own tracing (``mgf_tpu_torch.tracing``) over the
steps a ``--trace 1`` run makes with it on: ``tracing.summary``'s
``sphere_block_solve``, None where no stamped step ran the split solve
(the sphere pile's fused step, or a program without the stamp).  Nothing
to read in a ``--trace 0`` run."""

LAYER = "solver (solver.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "steps_per_s"
READS = "mgf_tpu_torch.tracing.summary: sphere_block_solve"


def read(ctx):
    prog = ctx.get("program")
    return prog["summary"].get("sphere_block_solve") if prog else None

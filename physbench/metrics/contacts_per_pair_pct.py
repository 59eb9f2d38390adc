"""The program's valid constraint rows per tested pair: its device
counters ``contacts`` over ``pairs_tested``.  ``contacts`` counts the rows
after compaction, the terrain rows (K5's in the sphere step) with the pair
rows, so this is no share of the tested pairs: it can pass 100, and a
change to the terrain stage or to ``solver_rows`` moves it too.

Read from the program's own tracing (``mgf_tpu_torch.tracing``) over the
steps a ``--trace 1`` run makes with it on: ``tracing.summary``'s
``contacts_per_pair_pct``.  Nothing to read in a ``--trace 0`` run."""

LAYER = "narrowphase (collision.py)"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "steps_per_s"
READS = "mgf_tpu_torch.tracing.summary: contacts_per_pair_pct"


def read(ctx):
    prog = ctx.get("program")
    return prog["summary"].get("contacts_per_pair_pct") if prog else None

"""Milliseconds a lex batch: the time inside the backend's
``lex_solve_batch`` calls over its batches (``device_batches``).  Each
batch ends in its result copy, which waits for the card."""

UNIT, LAYER, MOVES = "ms", "lex backend", "front_s"


def read(run):
    batches = run.total("device_batches")
    return 1e3 * sum(f.lex_s for f in run.fronts) / batches if batches else None

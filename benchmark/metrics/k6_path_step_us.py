"""Microseconds a critical-path step of K6: K6's device time in the trace
over ``path_iters``, the LP steps of each launch's longest lane, summed:
the one-lane chain that sets each launch's length."""

UNIT, LAYER, MOVES = "us", "K6 kernel", "front_s"


def read(run):
    if run.trace is None:
        return None
    device_s = run.trace.op_seconds("lex_bnb")
    steps = run.total("path_iters")
    return 1e6 * device_s / steps if device_s > 0 and steps else None

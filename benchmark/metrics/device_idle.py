"""The card's idle share of the window, in %: one less the union of its
operations' intervals (kernels, copies, sets) in the trace, over the
window."""

UNIT, LAYER, MOVES = "%", "device", "front_s"


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or t.ops == 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)

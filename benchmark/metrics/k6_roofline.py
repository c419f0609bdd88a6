"""K6's share of its roofline, in %: the least time the card could take for
the window's K6 launches, at the published H100 peaks (``roofline.py``),
over K6's device time in the trace.

The least time of a front is the larger of its launches' bytes and their
float64 operations, each summed over the front, at the peaks; that is no
more than the sum over its launches of each launch's larger one.  The
operations count a node's start and a step's pricing from the per-lane
nodes and LP steps K6 returns; the card reports no pivots, so the rank-1
updates of the pivots are left out, and the share is a lower bound."""

import roofline

UNIT, LAYER, MOVES = "%", "K6 kernel", "front_s"


def read(run):
    if run.trace is None:
        return None
    device_s = run.trace.op_seconds("lex_bnb")
    if device_s <= 0:
        return None
    least = 0.0
    for f in run.fronts:
        s = f.stats
        if not s.get("kernel_launches"):
            continue
        nbytes = roofline.k6_bytes(f.m, f.n, f.k, s["kernel_launches"], s["lanes"])
        flops = roofline.k6_flops(f.m, f.n, s["nodes"], s["iters"])
        least += roofline.least_seconds(nbytes, flops)
    return 100.0 * least / device_s

"""Milliseconds a front in the relaxation store: the seconds of the
program's ``store.find``, ``store.insert`` and ``store.merge`` counters
(each call of the store's ``find``, ``insert`` and ``merge``, native or
NumPy) over the window's completed fronts.  Read from the program's
recorder (``moip_aira_tpu_torch.utils.trace``) after the window; None where
it counted no store call."""

UNIT, LAYER, MOVES = "ms", "AIRA scheduler", "front_s"

NAMES = ("store.find", "store.insert", "store.merge")


def read(run):
    from moip_aira_tpu_torch.utils import trace

    rec = trace.GLOBAL_TIMINGS
    fronts = sum(1 for f in run.fronts if f.points is not None)
    if not fronts or not any(rec.counts.get(name) for name in NAMES):
        return None
    return 1e3 * sum(rec.totals.get(name, 0.0) for name in NAMES) / fronts

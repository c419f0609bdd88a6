"""The store's useful share, in %: the program's ``store.hit`` counter
over its ``store.lookup`` counter.  A lookup is a worker's relaxation
lookup (``engine/worker.aira_worker``); a hit is one that a stored
relaxation answers, so no IP is solved.  A count that repeats exactly over
whole cycles.  Read from the program's recorder
(``moip_aira_tpu_torch.utils.trace``) after the window; None where it
counted no lookup."""

UNIT, LAYER, MOVES = "%", "AIRA scheduler", "front_s"


def read(run):
    from moip_aira_tpu_torch.utils import trace

    rec = trace.GLOBAL_TIMINGS
    lookups = rec.counts.get("store.lookup", 0)
    return 100.0 * rec.counts.get("store.hit", 0) / lookups if lookups else None

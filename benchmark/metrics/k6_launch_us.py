"""Microseconds of K6's host launch: the program's ``lex.launch`` spans
(``LexKernel._launch``: reading the previous call's counts, the wrapper's
checks and allocations, the ctypes call, the event) over their count.
Read from the program's recorder (``moip_aira_tpu_torch.utils.trace``)
after the window; None where it holds no launch."""

UNIT, LAYER, MOVES = "us", "lex backend", "front_s"


def read(run):
    from moip_aira_tpu_torch.utils import trace

    rec = trace.GLOBAL_TIMINGS
    launches = rec.counts.get("lex.launch", 0)
    return 1e6 * rec.totals.get("lex.launch", 0.0) / launches if launches else None

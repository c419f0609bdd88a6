"""Microseconds of host work a lex batch: the program's ``lex.batch``
spans less their ``lex.copy`` spans (the result copies, during which the
host waits for K6), over the batches.  What is left (packing the inputs,
K6's host launch, building the outcomes) is the host's own part of a
batch, while the card idles.  Read from the program's recorder
(``moip_aira_tpu_torch.utils.trace``) after the window; None where it holds
no batch."""

UNIT, LAYER, MOVES = "us", "lex backend", "front_s"


def read(run):
    from moip_aira_tpu_torch.utils import trace

    rec = trace.GLOBAL_TIMINGS
    batches = rec.counts.get("lex.batch", 0)
    if not batches:
        return None
    return 1e6 * (rec.totals.get("lex.batch", 0.0) - rec.totals.get("lex.copy", 0.0)) / batches

"""The AIRA scheduler's own host milliseconds a front: the program's
``front`` spans (``api.solve_front``, the whole call) less the ``lex.batch``
spans inside them (``TorchLexBackend._solve_chunk``, one K6 batch each),
over the window's completed fronts.  That is the scheduler, EPP's range work
and the store, without reading the LP or building the backend.  Read from
the program's recorder (``moip_aira_tpu_torch.utils.trace``) after the
window, which a running ``torch.profiler`` switches on; None where it holds
no front (an untraced or CPU run, or a program without the spans)."""

UNIT, LAYER, MOVES = "ms", "AIRA scheduler", "front_s"


def read(run):
    from moip_aira_tpu_torch.utils import trace

    rec = trace.GLOBAL_TIMINGS
    fronts = sum(1 for f in run.fronts if f.points is not None)
    if not fronts or not rec.counts.get("front"):
        return None
    return 1e3 * (rec.totals.get("front", 0.0) - rec.totals.get("lex.batch", 0.0)) / fronts

"""K6's launches on its regs_block shape, in %: the program's
``lex.plan.regs_block`` counter (``LexKernel._launch``: a launch whose LP
fits a block's registers, one block a lane, a warp a window of 32 columns,
the whole LP in registers) over its ``lex.launch`` spans (one a K6
launch).  A count that repeats exactly.  Read from the program's recorder
(``moip_aira_tpu_torch.utils.trace``) after the window; None where it holds
no launch, 0 where no launch took the shape (so also on a program that has
no such shape)."""

UNIT, LAYER, MOVES = "%", "K6 kernel", "front_s"


def read(run):
    from moip_aira_tpu_torch.utils import trace

    rec = trace.GLOBAL_TIMINGS
    launches = rec.counts.get("lex.launch", 0)
    return 100.0 * rec.counts.get("lex.plan.regs_block", 0) / launches if launches else None

"""K4's share of its roofline, in %: the least time the card could take for
the window's K4 passes, at the published H100 bandwidth
(``roofline.k4_bytes``: each pass reads its table once and writes the other
once), over K4's device time in the trace (the kernels whose name holds
``kp_dp``).  None where the trace holds no K4 time."""

import roofline

UNIT, LAYER, MOVES = "%", "K4 kernel", "front_s"


def read(run):
    if run.trace is None:
        return None
    device_s = run.trace.op_seconds("kp_dp")
    if device_s <= 0:
        return None
    nbytes = sum(roofline.k4_bytes(f.stats["table_cells"], f.stats["kernel_launches"])
                 for f in run.fronts if f.stats.get("table_cells"))
    return 100.0 * roofline.least_seconds(nbytes, 0.0) / device_s

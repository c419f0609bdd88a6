"""Milliseconds a K4 pass: K4's device time in the trace (the kernels whose
name holds ``kp_dp``) over its launches (``kernel_launches`` of the fronts
the dense dynamic programme computed, one launch an item)."""

UNIT, LAYER, MOVES = "ms", "K4 kernel", "front_s"


def read(run):
    if run.trace is None:
        return None
    device_s = run.trace.op_seconds("kp_dp")
    launches = sum(int(f.stats.get("kernel_launches", 0)) for f in run.fronts
                   if f.stats.get("table_cells"))
    return 1e3 * device_s / launches if device_s > 0 and launches else None

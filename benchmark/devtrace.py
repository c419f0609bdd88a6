"""Reading a ``torch.profiler`` trace of the measured window.

The profiler's Chrome trace puts host annotations (``record_function``)
and device operations (kernels, copies, sets) on one clock, in
microseconds.  ``summarise`` takes the device operations inside the window
and returns what the per-layer readers and the result's ``device`` and
``breakdown`` need: the union of their intervals (busy time), their time by
name, and the device's idle time by the host span that was open at the
middle of each gap."""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from dataclasses import dataclass, field

#: Chrome trace categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the Chrome trace category of a host ``record_function`` span
HOST_CAT = "user_annotation"
#: the benchmark's own host spans, by the names ``run.py`` gives them
SPAN_PREFIX = "bench."


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    #: device seconds by operation name
    op_s: dict = field(default_factory=dict)
    #: device operations counted
    ops: int = 0
    #: idle seconds by the host span open at each gap's middle
    idle_by_span: dict = field(default_factory=dict)

    def op_seconds(self, part: str) -> float:
        """Device seconds of the operations whose name holds ``part``."""
        return sum(s for name, s in self.op_s.items() if part in name)


def load_events(path: str) -> list:
    with open(path) as fh:
        data = json.load(fh)
    return data["traceEvents"] if isinstance(data, dict) else data


def _window(events: list):
    """The window's start and end: the ``bench.window`` annotation."""
    for e in events:
        if e.get("name") == SPAN_PREFIX + "window" and e.get("cat") == HOST_CAT:
            return float(e["ts"]), float(e["ts"]) + float(e["dur"])
    raise ValueError("the trace holds no bench.window span")


def summarise(events: list) -> TraceSummary:
    w0, w1 = _window(events)
    ops = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            a = max(float(e["ts"]), w0)
            b = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
            if b > a:
                ops.append((a, b, e.get("name", "?")))
    ops.sort()
    op_s = defaultdict(float)
    busy, gaps = 0.0, []
    cur_a = cur_b = None
    edge = w0
    for a, b, name in ops:
        op_s[name] += (b - a) * 1e-6
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy += cur_b - cur_a
            gaps.append((edge, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
        edge = cur_b
    if cur_b is not None:
        busy += cur_b - cur_a
    gaps.append((edge, w1))

    spans = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"][len(SPAN_PREFIX):])
        for e in events
        if e.get("cat") == HOST_CAT and str(e.get("name", "")).startswith(SPAN_PREFIX)
        and e["name"] != SPAN_PREFIX + "window"
    )
    starts = [s[0] for s in spans]

    def open_span(t: float) -> str:
        # the innermost span holding t: the latest-starting one that has
        # not ended (spans nest)
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0:
            a, b, name = spans[i]
            if b >= t:
                return name
            i -= 1
        return "outside"

    idle = defaultdict(float)
    for a, b in gaps:
        if b > a:
            idle[open_span(0.5 * (a + b))] += (b - a) * 1e-6
    return TraceSummary(
        window_s=(w1 - w0) * 1e-6,
        busy_s=busy * 1e-6,
        op_s=dict(op_s),
        ops=len(ops),
        idle_by_span=dict(idle),
    )

"""Run one benchmark cell traced and read its window by the program's own
spans.

    python3 tools/idle_by_span.py --workload 3kp10-lex-sync2 --seed 7 --seconds 30

Runs ``benchmark/run.py``'s cell exactly as ``--trace 1`` does (the same
set-up, warm front, window and result line, printed first) and reads the
window's ``torch.profiler`` trace before it is deleted:

- ``idle_by_span``: the card's idle seconds in the window, each stretch
  given, by overlap, to the innermost ``moip.`` span open over it (the
  recorder's spans, ``moip_aira_tpu_torch/utils/trace.py``), and to
  ``outside`` where none is open: reading the LP, building the backend and
  the benchmark's own loop;
- ``k6_in_batch``: how many ``lex_bnb`` kernels lie wholly inside a
  ``moip.lex.batch`` span, of how many, and the widest overhang (µs) of
  those that do not: the spans on the kernels' clock;
- ``recorder``: each span's and counter's count, total and self seconds
  over the window, and ``bench_s``, the seconds of the benchmark's own
  ``read`` and ``build`` spans.

The last line of standard output is that JSON object.  ``--recorder``
runs the cell untraced with the recorder switched on after the warm front
instead: no profiler and its cost on every operator, so the window's spans
on the host clock alone, and the result line's per-layer metrics that read
them."""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
from collections import defaultdict

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(HERE, "benchmark")
sys.path.insert(0, BENCH)
sys.path.insert(1, HERE)

import devtrace  # noqa: E402
import registry  # noqa: E402
import run  # noqa: E402

PREFIX = "moip."


def device_gaps(events, w0, w1):
    """The window's stretches with no device operation, as devtrace
    counts operations."""
    ops = sorted(
        (max(float(e["ts"]), w0), min(float(e["ts"]) + float(e.get("dur", 0.0)), w1))
        for e in events
        if e.get("ph") == "X" and e.get("cat") in devtrace.DEVICE_CATS
    )
    gaps, edge = [], w0
    for a, b in ops:
        if b <= a:
            continue
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if w1 > edge:
        gaps.append((edge, w1))
    return gaps


def host_spans(events, prefix):
    return sorted(
        ((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"][len(prefix):])
         for e in events
         if e.get("cat") == devtrace.HOST_CAT and str(e.get("name", "")).startswith(prefix)),
        key=lambda s: (s[0], -s[1]),
    )


def idle_by_span(gaps, spans, w0, w1) -> dict:
    """Idle seconds by the innermost span open over each piece of each
    gap; the spans nest (one host thread)."""
    bounds = sorted({w0, w1, *(t for g in gaps for t in g),
                     *(t for a, b, _ in spans for t in (a, b) if w0 < t < w1)})
    idle = defaultdict(float)
    stack, i, gi = [], 0, 0
    for t0, t1 in zip(bounds, bounds[1:]):
        while i < len(spans) and spans[i][0] <= t0:
            while stack and stack[-1][1] <= spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] <= t0:
            stack.pop()
        while gi < len(gaps) and gaps[gi][1] <= t0:
            gi += 1
        if gi < len(gaps) and gaps[gi][0] <= t0:
            idle[stack[-1][2] if stack else "outside"] += (t1 - t0) * 1e-6
    return dict(sorted(idle.items(), key=lambda kv: -kv[1]))


def kernels_in_batches(events, spans) -> dict:
    batches = [(a, b) for a, b, name in spans if name == "lex.batch"]
    starts = [a for a, _ in batches]
    inside, over = 0, 0.0
    kernels = [
        (float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
        if e.get("cat") == "kernel" and "lex_bnb" in str(e.get("name", ""))
    ]
    for a, b in kernels:
        j = bisect.bisect_right(starts, a) - 1
        if j >= 0 and b <= batches[j][1]:
            inside += 1
        else:
            end = batches[j][1] if j >= 0 else a
            over = max(over, b - end)
    return {"inside": inside, "kernels": len(kernels), "batches": len(batches),
            "widest_overhang_us": over}


def recorder_table(rec) -> dict:
    """Each name's count, total and self seconds (None where it has none)."""
    return {
        name: [rec.counts[name], rec.totals.get(name), rec.self_s.get(name)]
        for name in sorted(rec.counts)
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--keep", metavar="FILE",
                    help="write the window's spans and device operations to FILE (JSON)")
    ap.add_argument("--recorder", action="store_true",
                    help="no profiler: the recorder on from the first front of the window")
    args = ap.parse_args(argv)

    from moip_aira_tpu_torch.utils import trace

    cell = registry.find_cell(args.workload)
    if args.recorder:
        guarded = run.guarded

        def recorded(*a, **kw):
            if not trace.GLOBAL_TIMINGS.enabled:
                trace.GLOBAL_TIMINGS.clear()
                trace.enable()
            return guarded(*a, **kw)

        run.guarded = recorded
        result, fronts = run.run_cell(cell, args.seed, args.seconds, False)
        trace.disable()
        window = run.Run(0.0, 0.0, fronts)
        for metric in registry.metrics_for(cell.name, "per_layer"):
            value = metric.read(window)
            if value is not None:
                result["metrics"][metric.name] = {"value": value, "unit": metric.unit}
        print(json.dumps(result))
        print(json.dumps({"recorder": recorder_table(trace.GLOBAL_TIMINGS)}))
        return 0

    found = {}
    summarise = devtrace.summarise

    def reading(events):
        w0, w1 = devtrace._window(events)
        spans = host_spans(events, PREFIX)
        found["idle_by_span"] = idle_by_span(device_gaps(events, w0, w1), spans, w0, w1)
        found["k6_in_batch"] = kernels_in_batches(events, spans)
        if args.keep:
            with open(args.keep, "w") as fh:
                json.dump([e for e in events if e.get("cat") in devtrace.DEVICE_CATS
                           or (e.get("cat") == devtrace.HOST_CAT
                               and str(e.get("name", "")).startswith((PREFIX, "bench.")))], fh)
        found["bench_s"] = {
            name: sum(b - a for a, b, n in host_spans(events, devtrace.SPAN_PREFIX)
                      if n == name) * 1e-6
            for name in ("read", "build")
        }
        return summarise(events)

    devtrace.summarise = reading
    result, fronts = run.run_cell(cell, args.seed, args.seconds, True)
    print(json.dumps(result))
    found["recorder"] = recorder_table(trace.GLOBAL_TIMINGS)
    found["fronts"] = sum(1 for f in fronts if f.points is not None)
    found["device_batches"] = run.Run(0, 0, fronts).total("device_batches")
    print(json.dumps(found))
    return 0


if __name__ == "__main__":
    sys.exit(main())

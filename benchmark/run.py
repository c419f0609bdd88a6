"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``) names a configuration, an instance family and
its instance set, and a traffic mix, the options of ``solve_front`` and the
backend.  One user solves fronts one after another (a closed loop): each
front reads an instance's LP text with ``moip_aira_tpu_torch.io.read_problem``
and computes its exact nondominated set with
``moip_aira_tpu_torch.api.solve_front`` on the card, through a proxy of the
backend that times each ``lex_solve_batch`` call.

Set-up imports, starts CUDA, loads the kernels (building them on a
checkout's first run, under ``build/kernels/``), writes the instance set as
LP files under ``$TMPDIR`` and solves one warm front.  The window then solves
the instance set in cycles, each cycle every instance once in an order drawn
from ``--seed``, and closes at the end of the first cycle that ends after
``--seconds``: every run does the same work.  After the window the plain
reference (``reference.py``) works out each instance's front and every front
of the window is compared with it (``judge.py``).  With ``--trace 1`` a
``torch.profiler`` trace of the window gives the per-layer metrics.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown`` with
``--trace 1``) and, last, ``checks``: each number compared with its limit.

``--device cpu`` (with ``--cut key=value`` to shrink the configuration) runs
the same path on the CPU with the kernels' plain versions, for the
benchmark's own tests; its numbers are no device's."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from contextlib import nullcontext  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

import instances  # noqa: E402
import judge  # noqa: E402
import registry  # noqa: E402

#: top-level module names that no run may load: JAX and the JAX package
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "moip_aira_tpu"})
#: the counters a front's ``backend_stats`` gives that the readers sum
COUNTERS = ("device_batches", "lanes", "kernel_launches", "nodes", "iters",
            "path_nodes", "path_iters", "fallback_count", "table_cells")


def forbidden_modules() -> list:
    """The forbidden top-level names in ``sys.modules``, each compared
    whole: ``moip_aira_tpu_torch`` is not ``moip_aira_tpu``."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & FORBIDDEN)


@dataclass
class Front:
    """One front of the window: the instance's index in the set, its
    problem's sizes, the points (None when it raised), the program's IP
    count and counters, the front's wall seconds and those inside the
    backend's ``lex_solve_batch`` calls."""

    index: int
    m: int = 0
    n: int = 0
    k: int = 0
    points: object = None
    ips: int = 0
    stats: dict = field(default_factory=dict)
    wall_s: float = 0.0
    lex_s: float = 0.0
    lex_calls: int = 0


@dataclass
class Run:
    """What the metric readers read."""

    setup_s: float
    window_s: float
    fronts: list
    trace: object = None  # devtrace.TraceSummary

    def total(self, key: str) -> int:
        return sum(int(f.stats.get(key, 0)) for f in self.fronts)


class TimedBackend:
    """The backend under test, with each ``lex_solve_batch`` call timed by
    the host clock (and, when tracing, marked as the span ``lex_call``);
    everything else is the backend's own."""

    def __init__(self, backend, span):
        self._backend = backend
        self._span = span
        self.seconds = 0.0
        self.calls = 0

    def __getattr__(self, name):
        return getattr(self._backend, name)

    def lex_solve_batch(self, reqs):
        t0 = time.perf_counter()
        with self._span("lex_call"):
            out = self._backend.lex_solve_batch(reqs)
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return out


def make_span(tracing: bool):
    if not tracing:
        return lambda name: nullcontext()
    from torch.profiler import record_function

    return lambda name: record_function("bench." + name)


def solve(path: str, index: int, traffic: dict, device: str, span) -> Front:
    """One front of the instance at ``path``, as a user computes it."""
    from moip_aira_tpu_torch.api import make_backend, solve_front
    from moip_aira_tpu_torch.io import read_problem

    front = Front(index)
    t0 = time.perf_counter()
    with span("front"):
        with span("read"):
            problem = read_problem(path)
        front.m, front.n, front.k = problem.m_total, problem.n, problem.objcnt
        with span("build"):
            backend = TimedBackend(make_backend(problem, traffic["backend"], device=device), span)
        with span("solve"):
            res = solve_front(
                problem, n_workers=traffic["n_workers"], spread=traffic["spread"],
                split=traffic["split"], split_normal=traffic["split_normal"],
                backend=backend, device=device, dp=traffic["dp"], sweep=traffic["sweep"],
            )
    front.wall_s = time.perf_counter() - t0
    front.points = res.points
    front.ips = int(res.ip_count)
    front.stats = {key: res.backend_stats[key] for key in COUNTERS
                   if key in (res.backend_stats or {})}
    front.lex_s, front.lex_calls = backend.seconds, backend.calls
    return front


def guarded(path, index, traffic, device, span) -> Front:
    """``solve``, with a front that raises counted as failed."""
    try:
        return solve(path, index, traffic, device, span)
    except Exception:  # noqa: BLE001 - a failed front is reported, not fatal
        traceback.print_exc(file=sys.stderr)
        return Front(index)


def device_info(device: str, chips: int) -> dict:
    import torch

    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": chips,
        "memory_peak_bytes": max(int(torch.cuda.max_memory_allocated(i)) for i in range(chips)),
    }


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(cell: registry.Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float = T_START) -> tuple:
    """Set up, warm up, measure, check.  Returns the result line's dict and
    the window's fronts."""
    import torch

    config, traffic = cell.config, cell.traffic
    tracing = trace and device != "cpu"
    span = make_span(tracing)
    insts = instances.instance_set(config)
    with tempfile.TemporaryDirectory(prefix="moip-bench-") as tmp:
        paths = []
        for inst in insts:
            path = os.path.join(tmp, inst.name + ".lp")
            with open(path, "w") as fh:
                fh.write(inst.text)
            paths.append(path)
        # the warm front, always the set's first instance: K6 loaded, its
        # plans worked out, every host path run once
        solve(paths[0], 0, traffic, device, span)
        if device != "cpu":
            torch.cuda.synchronize()
        prof = None
        if tracing:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.start()
        fronts = []
        orders = instances.cycle_orders(len(insts), seed)
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        with span("window"):
            while True:
                for index in next(orders):
                    fronts.append(guarded(paths[index], index, traffic, device, span))
                if time.perf_counter() - t0 >= seconds:
                    break
        if device != "cpu":
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        summary = None
        if prof is not None:
            import devtrace

            prof.stop()
            trace_path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(trace_path)
            del prof
            summary = devtrace.summarise(devtrace.load_events(trace_path))
    dev = device_info(device, cell.chips)

    import reference

    t_ref = time.perf_counter()
    ref = {i: reference.front(insts[i]) for i in sorted({f.index for f in fronts})}
    print(f"reference: {len(ref)} fronts in {time.perf_counter() - t_ref:.3f} s",
          file=sys.stderr)
    checks, failed = judge.compare([(f.index, f.points) for f in fronts], ref)
    run = Run(setup_s, window_s, fronts, summary)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for metric in registry.metrics_for(cell.name, kind):
        value = metric.read(run)
        if value is not None:
            metrics[metric.name] = {"value": value, "unit": metric.unit}
    result = {
        "correct": judge.passes(checks) and bool(fronts),
        "attempted": len(fronts),
        "failed": failed,
        "metrics": metrics,
        "device": dev,
    }
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = {
            "device_ops": sorted(summary.op_s.items(), key=lambda x: -x[1])[:10],
            "idle_gaps": sorted(summary.idle_by_span.items(), key=lambda x: -x[1])[:10],
        }
    result["checks"] = checks
    return result, fronts


def parse_cut(items) -> dict:
    """``--cut key=value`` arguments, each value in JSON."""
    cut = {}
    for item in items or ():
        key, _, value = item.partition("=")
        cut[key] = json.loads(value)
    return cut


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: the kernels' plain versions, for tests")
    ap.add_argument("--cut", action="append", metavar="KEY=VALUE",
                    help="override a configuration key (a value in JSON): a tiny cut "
                    "for the tests, or another instance set; such a run is not the cell")
    ap.add_argument("--fronts-out", metavar="FILE",
                    help="write each front's instance, seconds and counts to FILE (JSON lines)")
    args = ap.parse_args(argv)

    cell = registry.find_cell(args.workload)
    if args.cut:
        cell.config = {**cell.config, **parse_cut(args.cut)}
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(
                f"{args.workload} needs {cell.chips} CUDA device(s); "
                f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
                f"device_count() {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                file=sys.stderr,
            )
            return 2
    result, fronts = run_cell(cell, args.seed, args.seconds, bool(args.trace), args.device)
    if args.fronts_out:
        with open(args.fronts_out, "w") as fh:
            for f in fronts:
                fh.write(json.dumps({
                    "index": f.index, "points": None if f.points is None else len(f.points),
                    "ips": f.ips, "wall_s": f.wall_s, "lex_s": f.lex_s,
                    "lex_calls": f.lex_calls, **f.stats,
                }) + "\n")
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded forbidden modules: {', '.join(bad)}", file=sys.stderr)
        return 3
    if args.device == "cuda":
        print(f"card: {power_limit()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

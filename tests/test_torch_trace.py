"""The port's recorder of spans and counters (``utils/trace.py``): off, it
reads no clock and opens no ``record_function``; under a profiler, or
switched on, a lex front's spans nest ``front`` > ``sched.round`` >
``lex.batch`` > its parts, its counters agree with the store and the
backend, and every span lands on the profiler's timeline.  The last test
needs a card and holds the spans to the kernels' clock."""

import json
import os
import subprocess
import sys
from contextlib import contextmanager

import numpy as np
import pytest
import torch

from moip_aira_tpu_torch import api
from moip_aira_tpu_torch.io import read_problem
from moip_aira_tpu_torch.utils import trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EX = os.path.join(REPO, "examples")
#: the lex front of these tests: the plain K6 loop on the CPU, 4 batches
FRONT = dict(n_workers=2, backend="jax", device="cpu", sweep="off", dp="off")
SPANS = {"front", "sched.round", "lex.batch", "lex.pack", "lex.launch", "lex.copy", "lex.unpack"}
PARENTS = {
    "front": set(), "sched.round": {"front"}, "lex.batch": {"sched.round", "front"},
    "lex.pack": {"lex.batch"}, "lex.launch": {"lex.batch"}, "lex.copy": {"lex.batch"},
    "lex.unpack": {"lex.batch"},
}


@pytest.fixture
def recorder(monkeypatch):
    """The recorder, off (whatever ``MOIP_FINETIMING`` says) and empty,
    and emptied again after the test."""
    rec = trace.GLOBAL_TIMINGS
    monkeypatch.setattr(rec, "enabled", False)
    rec.clear()
    yield rec
    rec.clear()


@contextmanager
def user_scope_profile(path):
    """A CPU ``torch.profiler`` session that records user scopes (the
    ``record_function`` spans) and no operators, saved as a Chrome trace at
    ``path``.  ``torch.profiler.profile`` also records every operator of
    the plain K6 loop: about 1.8 million events, 490 MB, for one G2AP05
    front."""
    from torch._C._autograd import _disable_profiler, _enable_profiler, _prepare_profiler
    from torch._C._profiler import (
        ProfilerActivity, ProfilerConfig, ProfilerState, RecordScope, _ExperimentalConfig,
    )

    cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                         _ExperimentalConfig())
    acts = {ProfilerActivity.CPU}
    _prepare_profiler(cfg, acts)
    _enable_profiler(cfg, acts, {RecordScope.USER_SCOPE})
    try:
        yield
    finally:
        _disable_profiler().save(path)


def counting_stores(monkeypatch, stores, finds):
    """``api.make_solutions`` made to return stores that log each ``find``
    (the store, whether a relaxation answered it); ``stores`` lists them in
    the order made: the front's store, then its infeasibles."""
    make = api.make_solutions

    def made(k):
        base = type(make(k))

        class Counting(base):
            def find(self, ip, sense):
                got = super().find(ip, sense)
                finds.append((self, got is not None))
                return got

        store = Counting(k)
        stores.append(store)
        return store

    monkeypatch.setattr(api, "make_solutions", made)


def lookups_and_hits(stores, finds):
    """A worker's relaxation lookup asks the infeasibles first, and its own
    store only when they miss: lookups are the infeasibles' finds, hits the
    finds a relaxation answered."""
    return sum(1 for s, _ in finds if s is stores[1]), sum(hit for _, hit in finds)


def g2ap05():
    return read_problem(os.path.join(EX, "G2AP05.lp"))


def test_recorder_off_reads_no_clock_and_opens_no_record_function(recorder, monkeypatch):
    calls = {"clock": 0, "record_function": 0}
    clock, mark = trace._now, trace.record_function

    def counted_clock():
        calls["clock"] += 1
        return clock()

    def counted_mark(name):
        calls["record_function"] += 1
        return mark(name)

    monkeypatch.setattr(trace, "_now", counted_clock)
    monkeypatch.setattr(trace, "record_function", counted_mark)
    monkeypatch.setattr(torch.profiler, "record_function", counted_mark)
    res = api.solve_front(g2ap05(), **FRONT)
    assert res.backend_stats["device_batches"] > 0 and len(res.points) > 0
    assert calls == {"clock": 0, "record_function": 0}
    assert not (recorder.totals or recorder.self_s or recorder.counts or recorder.parents)


@pytest.fixture(scope="module")
def profiled(tmp_path_factory):
    """The G2AP05 lex front under a CPU profiler: its result, the
    recorder's aggregates, the Chrome trace's events, and the lookups and
    hits of the front's stores, counted by wrapping them."""
    rec = trace.GLOBAL_TIMINGS
    path = str(tmp_path_factory.mktemp("trace") / "front.json")
    stores, finds = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rec, "enabled", False)
        counting_stores(mp, stores, finds)
        rec.clear()
        with user_scope_profile(path):
            res = api.solve_front(g2ap05(), **FRONT)
        got = {key: dict(getattr(rec, key)) for key in ("totals", "self_s", "counts", "parents")}
        rec.clear()
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return res, got, events, lookups_and_hits(stores, finds)


def intervals(events, name):
    return [
        (float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
        if e.get("cat") == "user_annotation" and e.get("name") == trace.PREFIX + name
    ]


def test_spans_nest_and_self_is_at_most_total(profiled):
    _, got, events, _ = profiled
    assert set(got["self_s"]) == SPANS
    for name in SPANS:
        assert set(got["parents"].get(name, ())) <= PARENTS[name], name
        assert 0.0 <= got["self_s"][name] <= got["totals"][name] + 1e-12, name
    assert got["counts"]["front"] == 1
    # the same nesting on the profiler's timeline
    for name, outer in (("sched.round", "front"), ("lex.batch", "sched.round"),
                        ("lex.pack", "lex.batch"), ("lex.launch", "lex.batch"),
                        ("lex.copy", "lex.batch"), ("lex.unpack", "lex.batch")):
        spans = intervals(events, outer)
        for a, b in intervals(events, name):
            assert any(a0 <= a and b <= b0 for a0, b0 in spans), (name, outer)


def test_lex_batch_count_is_device_batches(profiled):
    res, got, _, _ = profiled
    batches = res.backend_stats["device_batches"]
    assert batches > 0
    for name in ("lex.batch", "lex.pack", "lex.launch", "lex.copy", "lex.unpack"):
        assert got["counts"][name] == batches, name
    assert got["counts"]["sched.round"] == res.rounds


def test_store_counters_match_the_wrapped_store(profiled):
    _, got, _, (lookups, hits) = profiled
    counts = got["counts"]
    assert counts["store.lookup"] == lookups > 0
    assert counts.get("store.hit", 0) == hits
    assert counts["store.lookup"] >= counts.get("store.hit", 0) >= 0
    for name in ("store.find", "store.insert", "store.merge"):
        assert counts[name] > 0 and got["totals"][name] >= 0.0, name
        assert name not in got["self_s"], name  # a counter, not a span


def test_store_counters_count_hits(recorder, monkeypatch):
    """A front whose store answers lookups (G3KP10, the knapsack host
    backend): the counters equal the wrapped store's, hits included."""
    stores, finds = [], []
    counting_stores(monkeypatch, stores, finds)
    with trace.recording():
        api.solve_front(read_problem(os.path.join(EX, "G3KP10.lp")), n_workers=2,
                        backend="kpbb", device="cpu", sweep="off", dp="off")
    lookups, hits = lookups_and_hits(stores, finds)
    assert recorder.counts["store.lookup"] == lookups > recorder.counts["store.hit"] == hits > 0


def test_chrome_trace_holds_every_span_as_a_user_annotation(profiled):
    _, got, events, _ = profiled
    on_timeline = {}
    for e in events:
        name = str(e.get("name", ""))
        if name.startswith(trace.PREFIX):
            assert e.get("cat") == "user_annotation", e
            on_timeline[name[len(trace.PREFIX):]] = on_timeline.get(name[len(trace.PREFIX):], 0) + 1
    # every span, as often as recorded; no counter on the timeline
    assert on_timeline == {name: got["counts"][name] for name in SPANS}


def k6_launches_counted(recorder, monkeypatch, name):
    """Three ``LexKernel._launch`` calls on ``name``'s lanes, the last two
    while the recorder is on, each in a ``lex.launch`` span: the plans the
    wrapper picked (K6's rule on an H100's limits, recorded as the wrapper
    records them) and the kernel; the card's launch and events are stood in
    for here."""
    from moip_aira_tpu_torch.solver import cuda_lex, lex_torch

    p = read_problem(os.path.join(EX, f"{name}.lp"))
    kern = lex_torch.make_lex_kernel(p, device="cpu")
    plans = []

    def launch(W, rhs, *args, plan=None, plan_launches=None):
        m, nc = W.shape
        plan = cuda_lex.lex_plan_for(m, nc - m, rhs.shape[0], 232448, 132, {})
        plan_launches[plan.shape, plan.C, plan.P] += 1
        plans.append(plan)
        B = rhs.shape[0]
        z = torch.zeros(B, dtype=torch.int64)
        return cuda_lex.LexOut(z.int(), torch.zeros(B, kern.k, dtype=torch.int64), z.int(), z, z)

    class Done:
        def record(self, stream):
            pass

        def query(self):
            return True

    monkeypatch.setattr(lex_torch, "launch_lex_bnb", launch)
    monkeypatch.setattr(lex_torch.torch.cuda, "Event", Done)
    monkeypatch.setattr(lex_torch.torch.cuda, "current_stream", lambda dev: None)
    rhs = torch.as_tensor(np.tile(p.initial_rhs(), (3, 1)), dtype=torch.float64)
    perm = torch.tensor([list(range(p.objcnt))] * 3)
    kern._launch(rhs, perm)
    assert not recorder.counts
    with trace.recording():
        for _ in range(2):
            with recorder.span("lex.launch"):
                kern._launch(rhs, perm)
    return plans, kern


def test_a_k6_launch_on_the_regs_shape_counts_once(recorder, monkeypatch):
    """``LexKernel._launch`` counts ``lex.plan.regs`` once for each K6
    launch that ``launch_lex_bnb`` records on the regs shape (G3KP10's
    4 x 14 LPs), while the recorder is on, beside the ``lex.launch`` span;
    the card's launch (K6's rule on an H100's limits, recorded as the
    wrapper records it) and events are stood in for here."""
    plans, kern = k6_launches_counted(recorder, monkeypatch, "G3KP10")
    assert [(q.shape, q.P) for q in plans] == [("regs", 4)] * 3
    assert recorder.counts == {"lex.launch": 2, "lex.plan.regs": 2}
    assert kern.plan_launches == {("regs", 1, 4): 3} and kern.launches == 3


def test_a_k6_launch_on_the_regs_block_shape_counts_once(recorder, monkeypatch):
    """``LexKernel._launch`` counts ``lex.plan.regs_block`` (and no
    ``lex.plan.regs``) once for each K6 launch recorded on the regs_block
    shape (G3AP05's 13 x 38 LPs, a block of two warps), while the recorder
    is on."""
    plans, kern = k6_launches_counted(recorder, monkeypatch, "G3AP05")
    assert [(q.shape, q.P, q.threads) for q in plans] == [("regs_block", 1, 64)] * 3
    assert recorder.counts == {"lex.launch": 2, "lex.plan.regs_block": 2}
    assert kern.plan_launches == {("regs_block", 1, 1): 3} and kern.launches == 3


def test_enable_records_without_a_profiler(recorder, monkeypatch):
    marks = []
    monkeypatch.setattr(trace, "record_function", lambda name: marks.append(name))
    with recorder.span("outer"):
        pass
    assert not recorder.counts
    trace.enable()
    try:
        with recorder.span("outer"):
            with recorder.span("inner"):
                recorder.count("hits", 2)
            with recorder.span("inner"):
                pass
    finally:
        trace.disable()
    with recorder.span("outer"):
        pass
    assert marks == []  # no profiler: nothing on a timeline
    assert recorder.counts == {"outer": 1, "inner": 2, "hits": 2}
    assert recorder.parents == {"inner": {"outer"}}
    total, inner = recorder.totals["outer"], recorder.totals["inner"]
    assert recorder.self_s["outer"] == pytest.approx(total - inner, abs=1e-9)
    assert recorder.self_s["inner"] == pytest.approx(inner, abs=1e-12)
    summary = recorder.summary()
    assert "self" in summary.splitlines()[1]
    assert f"{recorder.self_s['outer']:9.3f}s" in summary


def test_finetiming_records_and_prints_self_at_exit():
    code = (
        "from moip_aira_tpu_torch.utils import trace\n"
        "assert trace.GLOBAL_TIMINGS.enabled\n"
        "rec = trace.GLOBAL_TIMINGS\n"
        "with rec.span('outer'):\n"
        "    with rec.span('inner'):\n"
        "        rec.count('store.lookup')\n"
    )
    env = {**os.environ, "MOIP_FINETIMING": "1", "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stderr[out.stderr.index("moip fine timing:"):].splitlines()
    assert lines[1].split() == ["name", "count", "total", "self"]
    rows = {line.split()[0]: line.split()[1:] for line in lines[2:]}
    assert rows["outer"][0] == rows["inner"][0] == "1"
    assert rows["store.lookup"] == ["1", "-", "-"]
    assert all(cell.endswith("s") for cell in rows["outer"][1:] + rows["inner"][1:])


def test_idle_by_span_gives_each_idle_stretch_to_the_innermost_span():
    """``tools/idle_by_span.py`` on a made-up window: idle time under no
    span is ``outside``, each other stretch goes to the innermost span
    open over it, and the K6 launch lies inside its batch."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "idle_by_span", os.path.join(REPO, "tools", "idle_by_span.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)

    def x(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    events = [
        x("user_annotation", "moip.front", 10, 80), x("user_annotation", "moip.sched.round", 20, 60),
        x("user_annotation", "moip.lex.batch", 30, 40), x("user_annotation", "moip.lex.launch", 32, 5),
        x("user_annotation", "moip.lex.copy", 40, 25), x("kernel", "lex_bnb_kernel", 35, 28),
        x("gpu_memcpy", "Memcpy DtoH", 63, 1),
    ]
    gaps = tool.device_gaps(events, 0.0, 100.0)
    assert gaps == [(0.0, 35.0), (64.0, 100.0)]
    spans = tool.host_spans(events, trace.PREFIX)
    idle = tool.idle_by_span(gaps, spans, 0.0, 100.0)
    want = {"outside": 20, "front": 20, "sched.round": 20, "lex.batch": 7, "lex.launch": 3,
            "lex.copy": 1}
    assert idle == pytest.approx({k: v * 1e-6 for k, v in want.items()})
    assert tool.kernels_in_batches(events, spans) == {
        "inside": 1, "kernels": 1, "batches": 1, "widest_overhang_us": 0.0}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_spans_share_the_kernels_clock(cuda_device, recorder, tmp_path):
    """Under a CUDA profiler, each K6 launch of a 32-lane G3KP10 batch
    starts after its ``moip.lex.launch`` span opens and ends before its
    ``moip.lex.copy`` span closes."""
    from torch.profiler import ProfilerActivity, profile

    from moip_aira_tpu_torch.solver.lex import LexRequest
    from moip_aira_tpu_torch.solver.lex_torch import TorchLexBackend

    p = read_problem(os.path.join(EX, "G3KP10.lp"))
    rng = np.random.default_rng(3)
    reqs = [
        LexRequest(rhs=p.initial_rhs() - rng.integers(0, 40, size=p.objcnt),
                   perm=list(rng.permutation(p.objcnt)))
        for _ in range(32)
    ]
    be = TorchLexBackend(p, device=cuda_device)
    be.lex_solve_batch(reqs)  # builds and loads K6
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            be.lex_solve_batch(reqs)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
        if e.get("cat") == "kernel" and "lex_bnb" in e.get("name", "")
    )
    launches = sorted(intervals(events, "lex.launch"))
    copies = sorted(intervals(events, "lex.copy"))
    assert len(kernels) == len(launches) == len(copies) == 3
    for (k0, k1), (l0, _), (_, c1) in zip(kernels, launches, copies):
        assert l0 <= k0 and k1 <= c1

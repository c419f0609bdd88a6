"""The readers of the program's own spans and counters
(``moip_aira_tpu_torch.utils.trace``): None on an empty recorder, and on a
program whose recorder has none of their names; their arithmetic on a
filled one."""

import numpy as np
import pytest

import registry
import run
from moip_aira_tpu_torch.utils import trace

READERS = ("sched_self_ms", "store_ms", "store_hit_share", "lex_host_us", "k6_launch_us")


def window(completed=2, failed=1):
    fronts = [run.Front(i, points=np.zeros((3, 3))) for i in range(completed)]
    fronts += [run.Front(completed + i) for i in range(failed)]
    return run.Run(setup_s=1.0, window_s=2.0, fronts=fronts)


@pytest.fixture
def rec(monkeypatch):
    """A fresh recorder in the program's place."""
    fresh = trace.Timings()
    monkeypatch.setattr(trace, "GLOBAL_TIMINGS", fresh)
    return fresh


def fill(rec, spans=(), counters=()):
    for name, count, seconds in spans:
        rec.counts[name] += count
        rec.totals[name] += seconds
        rec.self_s[name] += seconds
    for name, count, seconds in counters:
        rec.counts[name] += count
        if seconds is not None:
            rec.totals[name] += seconds


@pytest.mark.parametrize("name", READERS)
def test_reader_is_none_on_an_empty_recorder(rec, name):
    assert registry.load_reader(name).read(window()) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_is_none_on_a_recorder_without_its_names(rec, name):
    # a program whose one span is the scheduler's round, always recorded
    rec.totals["scheduler.solve_round"] += 3.0
    rec.counts["scheduler.solve_round"] += 40
    assert registry.load_reader(name).read(window()) is None


def test_sched_self_ms(rec):
    fill(rec, spans=[("front", 3, 1.5), ("sched.round", 30, 1.4), ("lex.batch", 60, 1.2)])
    # (1.5 - 1.2) s over the two completed fronts
    assert registry.load_reader("sched_self_ms").read(window()) == pytest.approx(150.0)
    assert registry.load_reader("sched_self_ms").read(window(completed=0)) is None


def test_store_ms(rec):
    fill(rec, counters=[("store.find", 500, 0.010), ("store.insert", 200, 0.004),
                        ("store.merge", 4, 0.002), ("store.lookup", 300, None)])
    assert registry.load_reader("store_ms").read(window(completed=4)) == pytest.approx(4.0)
    assert registry.load_reader("store_ms").read(window(completed=0)) is None


def test_store_hit_share(rec):
    fill(rec, counters=[("store.lookup", 400, None)])
    assert registry.load_reader("store_hit_share").read(window()) == 0.0
    fill(rec, counters=[("store.hit", 100, None)])
    assert registry.load_reader("store_hit_share").read(window()) == pytest.approx(25.0)


def test_lex_host_us(rec):
    fill(rec, spans=[("lex.batch", 50, 1.05), ("lex.copy", 50, 1.0), ("lex.pack", 50, 0.01)])
    # (1.05 - 1.0) s over 50 batches
    assert registry.load_reader("lex_host_us").read(window()) == pytest.approx(1000.0)


def test_k6_launch_us(rec):
    fill(rec, spans=[("lex.launch", 40, 0.004), ("lex.batch", 40, 1.0)])
    assert registry.load_reader("k6_launch_us").read(window()) == pytest.approx(100.0)

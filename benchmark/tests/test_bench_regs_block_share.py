"""The reader of K6's regs_block share (``metrics/k6_regs_block_share.py``):
None on a recorder with no K6 launch, 0 where no launch took the regs_block
shape (a program without the counter), its arithmetic on a filled
recorder."""

import numpy as np
import pytest

import registry
import run
from moip_aira_tpu_torch.utils import trace


def window():
    return run.Run(setup_s=1.0, window_s=2.0, fronts=[run.Front(0, points=np.zeros((3, 3)))])


@pytest.fixture
def rec(monkeypatch):
    fresh = trace.Timings()
    monkeypatch.setattr(trace, "GLOBAL_TIMINGS", fresh)
    return fresh


def test_k6_regs_block_share(rec):
    read = registry.load_reader("k6_regs_block_share").read
    assert read(window()) is None
    rec.counts["lex.launch"] += 40
    rec.totals["lex.launch"] += 0.004
    rec.counts["lex.plan.regs"] += 30  # the other shape's counter is not read
    assert read(window()) == 0.0
    rec.counts["lex.plan.regs_block"] += 10
    assert read(window()) == pytest.approx(25.0)

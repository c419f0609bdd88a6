"""The wave's four environment switches, on the fragment path on the CPU
(K3's plain version), with the reference's defaults and meanings:

- ``MOIP_FRAG_RETRIES=N`` (default 0): a node the device left unfinished
  (a lane stopped by its tick budget mid-LP, or an iteration-limited
  record) goes back to the device, warm from where it stopped, up to N
  times before the exact host LP takes it; ``frag_stats["resumed"]``
  counts those visits;
- ``MOIP_COURT=0``: no combinatorial court (solver/match_court.py), so the
  queued records close by exact host LPs;
- ``MOIP_WAVE_PROGRESS=N``: one stderr line every N fragment waves;
- ``MOIP_DUMP_ITERLIM=path``: each iteration-limited record that goes to
  the host is appended to ``path``, pickled.

Every front stays the bundled golden whatever the switches say."""

import os
import pickle

import numpy as np
import pytest
import torch

from moip_aira_tpu_torch.api import solve_front
from moip_aira_tpu_torch.io import read_problem
from moip_aira_tpu_torch.solver.wave import WaveLexBackend

EX = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
SWITCHES = ("MOIP_FRAG_RETRIES", "MOIP_COURT", "MOIP_WAVE_PROGRESS",
            "MOIP_DUMP_ITERLIM", "MOIP_FRAG_NODE_ITERS")


@pytest.fixture(autouse=True)
def unset(monkeypatch):
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def golden(name):
    rows = []
    for line in open(os.path.join(EX, f"{name}.out")):
        parts = line.split()
        if parts and all(p.lstrip("-").isdigit() for p in parts):
            rows.append([int(p) for p in parts])
    return np.array(rows)


def frag_front(name, max_ticks=None, **kw):
    p = read_problem(os.path.join(EX, f"{name}.lp"))
    be = WaveLexBackend(p, device="cpu", fragments=True, batch_width=8, **kw)
    if max_ticks is not None:
        be.frag_kernel.max_ticks = max_ticks
    front = solve_front(p, n_workers=1, backend=be, device="cpu")
    assert np.array_equal(front.points, golden(name))
    return be


def test_defaults_are_the_references():
    be = WaveLexBackend(read_problem(os.path.join(EX, "G2AP05.lp")), device="cpu",
                        fragments=True)
    assert be._retry_max == 0 and be._progress_every == 0
    assert be._match_court() is not None  # an assignment problem
    assert be.frag_stats["resumed"] == 0


@pytest.mark.parametrize("retries", ["0", "1"])
def test_frag_retries_resume_on_the_device(monkeypatch, retries):
    """A tick budget of 12 stops lanes in the middle of their first LP:
    with one retry each such root goes back to the device once (resumed),
    with none it goes to the host; the front is the golden either way."""
    monkeypatch.setenv("MOIP_FRAG_RETRIES", retries)
    be = frag_front("G2AP05", max_ticks=12)
    assert be._retry_max == int(retries)
    if retries == "1":
        assert be.frag_stats["resumed"] > 0
    else:
        assert be.frag_stats["resumed"] == 0


def test_frag_retries_resume_iteration_limited_records(monkeypatch):
    """A node budget of 3 pivots leaves iteration-limited records; with a
    retry they continue on the device from their own stopped basis."""
    monkeypatch.setenv("MOIP_FRAG_RETRIES", "1")
    monkeypatch.setenv("MOIP_FRAG_NODE_ITERS", "3")
    be = frag_front("G2AP05")
    assert be.frag_kernel.node_iters == 3
    assert be.frag_stats["resumed"] > 0 and be.frag_stats["why"]["iterlim"] > 0


def test_court_off(monkeypatch):
    """MOIP_COURT=0 builds no court: the queued records of a 3-pivot node
    budget close by exact host LPs alone."""
    monkeypatch.setenv("MOIP_COURT", "0")
    monkeypatch.setenv("MOIP_FRAG_NODE_ITERS", "3")
    be = frag_front("G2AP05")
    assert be._match_court() is None and "court" not in be.frag_stats
    assert be.frag_stats["host_recs"] > 0 and be.verify_fallbacks > 0
    monkeypatch.delenv("MOIP_COURT")
    on = frag_front("G2AP05")
    assert on._match_court() is not None and "court" in on.frag_stats


def test_progress_line(monkeypatch, capsys):
    monkeypatch.setenv("MOIP_WAVE_PROGRESS", "2")
    be = frag_front("G2AP05")
    lines = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("[wave]")]
    assert len(lines) == be.frag_stats["waves"] // 2 > 0
    assert "waves=2 " in lines[0] and "resume=0 " in lines[0] and "why={" in lines[0]


def test_dump_iterlim(monkeypatch, tmp_path):
    path = tmp_path / "iterlim.pkl"
    monkeypatch.setenv("MOIP_DUMP_ITERLIM", str(path))
    monkeypatch.setenv("MOIP_FRAG_NODE_ITERS", "3")
    be = frag_front("G2AP05")
    recs = []
    with open(path, "rb") as fh:
        while True:
            try:
                recs.append(pickle.load(fh))
            except EOFError:
                break
    assert len(recs) == be.frag_stats["why"]["iterlim"] > 0
    m, nc = be.m, be.n + be.m
    for r in recs:
        assert set(r) == {"node_lo", "node_hi", "llo", "lhi", "cvec", "basis", "atup", "iters"}
        assert r["basis"].shape == (m,) and r["atup"].shape == (nc,) and r["iters"] >= 3

"""The port's fragment path on the CPU: WaveLexBackend(fragments=True)
end to end, with K3's plain version walking the subtrees and the port's
copies of bb_audit and match_court proving them.  The contract is the
per-LP path's: exact lexicographic optima, fronts equal to the bundled
goldens (tests/test_wave_fragments.py holds the reference the same way)."""

import os

import numpy as np
import pytest

from moip_aira_tpu_torch.api import solve_front
from moip_aira_tpu_torch.io import read_problem
from moip_aira_tpu_torch.solver.cuda_lp import LAUNCHES
from moip_aira_tpu_torch.solver.lex import LexRequest, NumpyLexBackend
from moip_aira_tpu_torch.solver.wave import WaveLexBackend, fragments_auto

EX = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")


def golden(name):
    rows = []
    for line in open(os.path.join(EX, f"{name}.out")):
        parts = line.split()
        if parts and all(p.lstrip("-").isdigit() for p in parts):
            rows.append([int(p) for p in parts])
    return np.array(rows)


def frag_backend(p, **kw):
    kw.setdefault("batch_width", 8)
    return WaveLexBackend(p, device="cpu", fragments=True, **kw)


@pytest.mark.parametrize(
    "name,frag_nodes,workers",
    [
        ("G2AP05", 32, 2),  # k=2: the bound sweep
        ("G3AP05", 32, 2),  # k=3: the AIRA scheduler ladder
        ("G3KP10", 32, 2),
        ("G2AP05", 2, 2),  # a 2-node budget: budget stops, re-opened siblings
        ("G3KP10", 2, 1),
    ],
)
def test_fragment_front_matches_golden(name, frag_nodes, workers):
    p = read_problem(os.path.join(EX, f"{name}.lp"))
    be = frag_backend(p, frag_nodes=frag_nodes)
    assert be.fragments and be.frag_kernel.kernel == "bb_fragment"
    launches0 = dict(LAUNCHES)
    front = solve_front(p, n_workers=workers, backend=be, device="cpu")
    assert np.array_equal(front.points, golden(name))
    # the fragment path carried the search, on the plain version of K3
    fs = be.frag_stats
    assert be.device_waves == fs["waves"] > 0 and fs["records"] > 0
    assert be.frag_kernel.launches == 0 and LAUNCHES == launches0
    assert front.backend_stats["kernel"] == "bb_fragment"
    assert front.backend_stats["fragments"]["records"] == fs["records"]
    if frag_nodes == 2 and name == "G3KP10":
        assert fs["reopened"] > 0


def test_fragment_lex_parity_with_the_numpy_oracle():
    """Six seeded lex requests on the 50-item knapsack: the fragment path's
    statuses and objective vectors equal NumpyLexBackend's."""
    rng = np.random.default_rng(5)
    p = read_problem(os.path.join(EX, "G2KP50.lp"))
    reqs = []
    for _ in range(6):
        rhs = np.array([-np.inf, float(rng.integers(900, 1400))])
        perm = [0, 1] if rng.random() < 0.5 else [1, 0]
        reqs.append(LexRequest(rhs=rhs.copy(), perm=perm))
    got = frag_backend(p).lex_solve_batch(reqs)
    want = NumpyLexBackend(p).lex_solve_batch(reqs)
    for g, w in zip(got, want):
        assert g.status == w.status
        if w.result is not None:
            assert np.array_equal(g.result, w.result)


def test_fragments_auto(monkeypatch):
    """The auto decision (tests/test_wave_fragments.py:96-115 for the
    reference): off unless MOIP_FRAGMENTS turns it on, since the card's
    measurement favoured the per-LP path; MOIP_FRAGMENTS wins both ways."""
    monkeypatch.delenv("MOIP_FRAGMENTS", raising=False)
    assert not fragments_auto()
    monkeypatch.setenv("MOIP_FRAGMENTS", "")
    assert not fragments_auto()
    monkeypatch.setenv("MOIP_FRAGMENTS", "1")
    assert fragments_auto()
    monkeypatch.setenv("MOIP_FRAGMENTS", "0")
    assert not fragments_auto()
    p = read_problem(os.path.join(EX, "2AP20.lp"))
    assert WaveLexBackend(p, device="cpu", fragments=True).fragments
    monkeypatch.setenv("MOIP_FRAGMENTS", "1")
    assert WaveLexBackend(p, device="cpu").fragments
    monkeypatch.delenv("MOIP_FRAGMENTS")
    assert not WaveLexBackend(p, device="cpu").fragments  # auto on the CPU

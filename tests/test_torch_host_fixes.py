"""The host faults the port's copies fix, held against brute force and the
cold oracle (not against the JAX package, which still has them):

* a numerically singular warm basis no longer makes the exact host simplex
  (``simplex_np.solve_lp``, ``simplex_batch.solve_lp_batch``) claim a false
  INFEASIBLE or give up;
* ``ap_bb``: the lexicographic blend weight dominates a mixed-sign
  objective, the detection guard is the matching engine's own magnitude
  bound (instances past it go to the wave backend), and a warm ``x_hint``
  that is not a perfect matching is ignored.
"""

import itertools
import os

import numpy as np
import pytest

from moip_aira_tpu.solver.ap_bb import detect_ap_family as ref_detect_ap_family
from moip_aira_tpu.problem import Problem as RefProblem
from moip_aira_tpu.sense import Sense as RefSense
from moip_aira_tpu_torch.api import make_backend
from moip_aira_tpu_torch.io import read_problem
from moip_aira_tpu_torch.problem import Problem
from moip_aira_tpu_torch.sense import Sense
from moip_aira_tpu_torch.solver.ap_bb import (
    APIPSolver,
    APLexBackend,
    BlendMagnitudeError,
    detect_ap_family,
)
from moip_aira_tpu_torch.solver.lex import LexRequest
from moip_aira_tpu_torch.solver.simplex_batch import solve_lp_batch
from moip_aira_tpu_torch.solver.simplex_np import SimplexWorkspace, solve_lp
from moip_aira_tpu_torch.solver.status import SolveStatus
from moip_aira_tpu_torch.solver.wave import WaveLexBackend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPRO = os.path.join(REPO, "tests", "data", "simplex_warm_false_infeasible_2ap20.npz")


# ---------------------------------------------------------------- simplex
@pytest.fixture(scope="module")
def repro():
    d = np.load(REPRO)
    p = read_problem(os.path.join(REPO, "examples", "2AP20.lp"))
    ws = SimplexWorkspace(np.vstack([p.A, p.C]))
    cold = solve_lp(ws, d["c"], d["lo"], d["hi"])
    assert cold.status == SolveStatus.OPTIMAL
    assert cold.obj == pytest.approx(32.5556, abs=1e-4)
    return ws, d, cold


def test_simplex_np_warm_singular_basis_is_not_infeasible(repro):
    ws, d, cold = repro
    B = ws.W[:, d["wb"].astype(np.int64)]
    assert np.linalg.cond(B) > 1e15  # the basis the fault came from
    r = solve_lp(ws, d["c"], d["lo"], d["hi"],
                 warm_basis=d["wb"], warm_at_upper=d["wa"])
    assert r.status == SolveStatus.OPTIMAL
    assert r.obj == pytest.approx(cold.obj, abs=1e-9)


def test_simplex_batch_warm_singular_basis_is_optimal(repro):
    ws, d, cold = repro
    S = 3
    c = np.tile(d["c"], (S, 1))
    lo = np.tile(d["lo"], (S, 1))
    hi = np.tile(d["hi"], (S, 1))
    wb = np.tile(d["wb"], (S, 1)).astype(np.int64)
    wb[1] = -1  # one cold lane beside the warm ones
    wa = np.tile(d["wa"], (S, 1))
    for r in solve_lp_batch(ws, c, lo, hi, warm_basis=wb, warm_at_upper=wa):
        assert r.status == SolveStatus.OPTIMAL
        assert r.obj == pytest.approx(cold.obj, abs=1e-9)


# ----------------------------------------------------------------- ap_bb
N7 = 7
PERMS7 = np.array(list(itertools.permutations(range(N7))))  # 5,040


def ap_problem(C, N, P=Problem, S=Sense):
    n = N * N
    A = np.zeros((2 * N, n))
    for a in range(N):
        for b in range(N):
            A[a, a * N + b] = 1.0
            A[N + b, a * N + b] = 1.0
    return P(
        objcnt=C.shape[0], objsen=S.MIN,
        var_names=[f"x{i}" for i in range(n)], C=np.asarray(C, dtype=float),
        A=A, row_lb=np.ones(2 * N), row_ub=np.ones(2 * N),
        lb=np.zeros(n), ub=np.ones(n), is_int=np.ones(n, dtype=bool),
        filename=f"ap{N}",
    )


def all_values(C, N):
    """(N!, k) objective values of every perfect matching."""
    perms = PERMS7 if N == N7 else np.array(list(itertools.permutations(range(N))))
    cols = np.arange(N)[None, :] * N + perms
    return np.asarray(C)[:, cols].sum(axis=2).T


def brute_lex(vals, rhs, perm):
    """Lexicographic optimum under V[l].x <= rhs_l by enumeration."""
    feas = np.all(vals <= np.asarray(rhs)[None, :], axis=1)
    if not feas.any():
        return None
    for j in perm:
        feas &= vals[:, j] == vals[feas, j].min()
    return tuple(int(v) for v in vals[np.flatnonzero(feas)[0]])


def mixed_sign_ap(seed):
    """A mixed-sign N=7 instance with a planted trap: matching A (f = +20
    per cell, g = 0) is the only one with g <= 0, and matching B, a 7-cycle
    away (f = -20 per cell, g = 1 in total), is the unconstrained optimum.
    f.x spreads over 280 across the two, more than the old blend weight
    N*max|f| + 1 = 141, so the old blend preferred B and closed the box
    g <= 0 as infeasible."""
    rng = np.random.default_rng(seed)
    N, n = N7, N7 * N7
    sig = rng.permutation(N)
    a_cells = np.arange(N) * N + sig
    b_cells = np.arange(N) * N + sig[np.roll(np.arange(N), 1)]
    f = rng.integers(-5, 6, size=n)
    g = rng.integers(2, 10, size=n)
    f[a_cells], f[b_cells] = 20, -20
    g[a_cells], g[b_cells] = 0, 0
    g[b_cells[rng.integers(N)]] = 1
    return np.stack([f, g]), rng


@pytest.mark.parametrize("seed", range(4))
def test_ap_bb_mixed_sign_matches_brute_force(seed):
    C, rng = mixed_sign_ap(seed)
    vals = all_values(C, N7)
    reqs = [(np.array([np.inf, 0.0]), [0, 1])]  # the planted box
    for _ in range(6):
        rhs = np.array(
            [float(rng.integers(vals[:, j].min(), vals[:, j].max() + 1))
             for j in range(2)]
        )
        reqs += [(rhs, [0, 1]), (rhs, [1, 0])]
    be = APLexBackend(ap_problem(C, N7))
    for rhs, perm in reqs:
        out = be.lex_solve(LexRequest(rhs=rhs, perm=perm))
        got = None if out.result is None else tuple(int(v) for v in out.result)
        assert got == brute_lex(vals, rhs, perm), (rhs, perm)
    planted = be.lex_solve(LexRequest(rhs=reqs[0][0], perm=[0, 1]))
    assert planted.status == SolveStatus.OPTIMAL


def test_ap_bb_past_the_guard_goes_to_the_wave_backend():
    """Objectives of 2^16 at N = 5: the old detection guard accepted them,
    and the matching engine's magnitude assert then fired mid-solve.  The
    aligned guard keeps them out of the family, so auto picks the wave."""
    rng = np.random.default_rng(3)
    N = 5
    C = rng.integers(0, 1 << 16, size=(2, N * N))
    C[0, 0] = 1 << 16
    p = ap_problem(C, N)
    assert ref_detect_ap_family(ap_problem(C, N, RefProblem, RefSense)) is not None
    assert detect_ap_family(p) is None
    be = make_backend(p, "auto", device="cpu")
    assert isinstance(be, WaveLexBackend)
    vals = all_values(C, N)
    rhs = np.array([np.inf, float(np.median(vals[:, 1]))])
    for perm in ([0, 1], [1, 0]):
        out = be.lex_solve_batch([LexRequest(rhs=rhs, perm=perm)])[0]
        assert tuple(int(v) for v in out.result) == brute_lex(vals, rhs, perm)
    # the matching engine itself refuses such a blend with a typed error
    fam = detect_ap_family(ap_problem(C // 256, N))
    assert fam is not None
    with pytest.raises(BlendMagnitudeError):
        APIPSolver(fam)._match_min(
            np.full(N * N, 1 << 40, dtype=np.int64), np.arange(N * N)
        )


def test_ap_bb_rejects_a_hint_that_is_not_a_matching():
    """A 0/1 hint of N cells in one side-A line is no assignment; taken as
    an incumbent it would undercut every real matching."""
    rng = np.random.default_rng(11)
    N, n = N7, N7 * N7
    C = rng.integers(0, 20, size=(2, n))
    C[0, :N] = -50  # side-A line 0: every cell very cheap
    solver = APIPSolver(detect_ap_family(ap_problem(C, N)))
    bad = np.zeros(n)
    bad[:N] = 1.0  # N cells, all in line 0
    opt, x = solver.solve(0, [], [], x_hint=bad)
    assert opt == all_values(C, N)[:, 0].min()
    assert np.all(np.bincount(np.flatnonzero(x) // N, minlength=N) == 1)
    frac = np.full(n, 1.0 / N)  # not 0/1 at all
    assert solver.solve(0, [], [], x_hint=frac)[0] == opt

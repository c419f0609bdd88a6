"""Lexicographic CLMOIP solve — the kernel the AIRA layer calls.

Reference parity: ``solve`` in src/aira.cpp:452-536.  For each objective in
the worker's permutation order: optimise it as a single-objective MIP subject
to the objective-bound rows, then fix its bound to the rounded optimum
(``result[j] = srhs[j] = round(objval)``, aira.cpp:517) and move to the next
stage.  An infeasible stage aborts the whole solve (aira.cpp:489-492).

Deliberate divergence: the reference lexicographically optimises only the
first ``t->nObj()`` objectives and merely *evaluates* the rest from the final
variable vector (aira.cpp:523-530), so for short-permutation workers (the EPP
recursion's lower levels) the reported point depends on CPLEX's arbitrary
tie-breaking and may be dominated.  Here every stage is optimised, so every
emitted point is a full lexicographic optimum of a downward-closed box and
therefore globally nondominated — output parity is preserved (the golden
fronts are exactly the nondominated sets) while removing solver-dependent
nondeterminism.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from moip_aira_tpu_torch.problem import Problem
from moip_aira_tpu_torch.sense import INF, Sense
from moip_aira_tpu_torch.solver.bnb_np import solve_mip
from moip_aira_tpu_torch.solver.simplex_np import SimplexWorkspace
from moip_aira_tpu_torch.solver.status import SolveStatus


class LexRequest(NamedTuple):
    """One CLMOIP subproblem: an objective-bound vector and a permutation.

    ``x_hint`` is an optional integer point from a RELATED solve (e.g. the
    parent rung of a bound-sweep chain, solver/sweep.py): it may violate the
    new objective-bound row by a front step, so backends repair it
    (solver/heuristics.py repair) into a warm incumbent before use.  Purely
    advisory — correctness never depends on it."""

    rhs: np.ndarray  # (objcnt,) float, +-inf allowed
    perm: Sequence[int]  # full permutation of range(objcnt)
    x_hint: Optional[np.ndarray] = None  # (n,) structural point or None


class LexOutcome(NamedTuple):
    status: SolveStatus
    result: Optional[np.ndarray]  # (objcnt,) int64 objective values
    ip_solves: int  # number of single-objective MIPs solved
    x: Optional[np.ndarray] = None  # optimal structural point (if tracked)


class NumpyLexBackend:
    """Host (NumPy) implementation; oracle for the JAX backend."""

    name = "numpy"

    def __init__(self, problem: Problem):
        self.problem = problem
        self.ws = SimplexWorkspace(problem.full_row_matrix())
        p = problem
        self._lo_base = np.concatenate([p.lb, p.row_lb, np.zeros(p.objcnt)])
        self._hi_base = np.concatenate([p.ub, p.row_ub, np.zeros(p.objcnt)])
        self._is_int = p.is_int
        # objective integrality: integer coefficients over integer variables
        self._obj_integral = [
            bool(
                np.all(p.C[j] == np.rint(p.C[j]))
                and np.all(p.is_int[np.abs(p.C[j]) > 0])
            )
            for j in range(p.objcnt)
        ]

    def lex_solve(self, req: LexRequest) -> LexOutcome:
        p = self.problem
        k = p.objcnt
        srhs = np.asarray(req.rhs, dtype=np.float64).copy()
        result = np.zeros(k, dtype=np.int64)
        lo = self._lo_base.copy()
        hi = self._hi_base.copy()
        nrow_off = p.n + p.m_struct
        ips = 0
        x_prev = None  # previous stage's optimum: feasible for the next stage
        for j in req.perm:
            # objective-bound rows: MIN -> C[j]@x <= srhs[j]; MAX -> >=
            if p.objsen is Sense.MIN:
                lo[nrow_off : nrow_off + k] = -INF
                hi[nrow_off : nrow_off + k] = srhs
                c = p.C[j]
            else:
                lo[nrow_off : nrow_off + k] = srhs
                hi[nrow_off : nrow_off + k] = INF
                c = -p.C[j]
            r = solve_mip(
                self.ws, c, lo, hi, self._is_int, self._obj_integral[j],
                incumbent_x=x_prev,
            )
            ips += 1
            if r.status.is_infeasible:
                return LexOutcome(SolveStatus.INFEASIBLE, None, ips)
            if r.status in (SolveStatus.ITERATION_LIMIT, SolveStatus.NODE_LIMIT):
                raise RuntimeError(
                    f"MIP resource limit hit on objective {j} of {p.filename}"
                )
            x_prev = r.x
            val = r.obj if p.objsen is Sense.MIN else -r.obj
            result[j] = int(np.rint(val))
            srhs[j] = float(result[j])
        return LexOutcome(SolveStatus.OPTIMAL, result, ips)

    def lex_solve_batch(self, reqs: List[LexRequest]) -> List[LexOutcome]:
        return [self.lex_solve(r) for r in reqs]

"""Branch-and-bound MIP solve over the NumPy simplex — host reference backend.

This replaces the reference's ``CPXmipopt`` call (src/aira.cpp:480-487).  The
search is depth-first with best-bound pruning; with all-integer objective data
the bound is rounded up (``ceil``) before pruning, which both prunes harder
and guarantees the exact integer optimum the AIRA layer relies on
(aira.cpp:517 rounds the CPLEX objective to an int).

MIP machinery beyond the plain tree walk (all three matter enormously on the
knapsack family — they cut 2KP50 stage MIPs from thousands of nodes to tens):

* **warm incumbents** — the lexicographic driver passes the previous stage's
  optimal point, which is always feasible for the next stage (its objective
  bound was fixed at the achieved value), giving a strong bound from node 0;
* **rounding heuristic** — at every LP-feasible node the rounded and floored
  LP points are feasibility-checked and adopted as incumbents when better;
* **ceiling-biased branching** — the child nearest the LP value is explored
  first (DFS dives toward the LP optimum instead of away from it).
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple, Optional

import numpy as np

#: branching-rule experiment knob: "mf" (most fractional, default),
#: "cost" (max |c_j| among fractional), "costfrac" (|c_j| * centrality)
_BRANCH_RULE = os.environ.get("MOIP_BRANCH", "mf")

from moip_aira_tpu_torch.solver.heuristics import local_search
from moip_aira_tpu_torch.solver.simplex_np import LPResult, SimplexWorkspace, solve_lp
from moip_aira_tpu_torch.solver.status import SolveStatus

INT_TOL = 1e-6


#: nodes the most recent solve_mip call explored (profiling diagnostic)
LAST_NODES = 0


class MIPResult(NamedTuple):
    status: SolveStatus
    obj: float
    x: Optional[np.ndarray]


def check_candidate(
    ws: SimplexWorkspace,
    c: np.ndarray,
    lo: np.ndarray,
    hi: np.ndarray,
    x: np.ndarray,
    tol: float = 1e-7,
) -> Optional[float]:
    """Return c @ x if the integer candidate x is feasible, else None."""
    n = ws.n
    if np.any(x < lo[:n] - tol) or np.any(x > hi[:n] + tol):
        return None
    act = ws.W[:, :n] @ x  # row activities (A_full @ x)
    if np.any(act < lo[n:] - tol) or np.any(act > hi[n:] + tol):
        return None
    return float(c @ x)


def solve_mip(
    ws: SimplexWorkspace,
    c: np.ndarray,
    lo: np.ndarray,
    hi: np.ndarray,
    is_int: np.ndarray,
    integral_objective: bool,
    max_nodes: int = 200000,
    incumbent_x: Optional[np.ndarray] = None,
    root_cuts: Optional[bool] = None,
) -> MIPResult:
    """Minimise c @ x with z-bounds (lo, hi) and integrality on x[is_int].

    ``root_cuts`` runs a cut-and-branch root loop first (extended cover
    cuts, solver/cuts.py) — integer-combinatorial cuts that are exactly
    valid, appended as ordinary rows before the tree search.  Default OFF:
    measured on the KP2D ladder the extended covers reduce easy-instance
    trees ~20% but GROW the hardest trees up to 3x (near-uniform weights
    make covers barely stronger than the LP's own packing limit, and the
    extra rows perturb the DFS trajectory); MOIP_CUTS=1 opts in.
    """
    n_int = int(np.count_nonzero(is_int))
    int_idx = np.flatnonzero(is_int)

    if root_cuts is None:
        root_cuts = n_int > 0 and os.environ.get("MOIP_CUTS", "0") == "1"
    if root_cuts and n_int:
        ws, lo, hi = _root_cut_loop(ws, c, lo, hi, is_int)

    best_obj = np.inf
    best_x: Optional[np.ndarray] = None

    ls_budget = 12  # local-search polish calls per MIP

    # warm incumbent from the caller (e.g. the previous lexicographic stage)
    if incumbent_x is not None:
        v = check_candidate(ws, c, lo, hi, incumbent_x)
        if v is not None:
            bx = np.asarray(incumbent_x, dtype=np.float64).copy()
            if int_idx.size:
                bx, v = local_search(ws.W[:, : ws.n], c, lo, hi, bx, int_idx)
                ls_budget -= 1
            best_obj = v
            best_x = bx

    prune_eps = INT_TOL if integral_objective else 1e-9

    # node stack holds (lo_x_over, hi_x_over, warm_basis, warm_at_upper);
    # children restart from the parent's optimal basis — on the degenerate
    # assignment family a cold phase-1 burns hundreds of pivots per node
    # where the parent basis re-attains feasibility in a handful (solve_lp
    # validates the basis and silently falls back to cold when it loses)
    stack = [(lo[: ws.n].copy(), hi[: ws.n].copy(), None, None)]
    nodes = 0
    lo_full = lo.copy()
    hi_full = hi.copy()

    global LAST_NODES
    while stack:
        nodes += 1
        LAST_NODES = nodes
        if nodes > max_nodes:
            return MIPResult(SolveStatus.NODE_LIMIT, best_obj, best_x)
        node_lo, node_hi, wb, wa = stack.pop()
        lo_full[: len(node_lo)] = node_lo
        hi_full[: len(node_hi)] = node_hi
        r = solve_lp(ws, c, lo_full, hi_full, warm_basis=wb, warm_at_upper=wa)
        if r.status == SolveStatus.INFEASIBLE:
            continue
        if r.status == SolveStatus.UNBOUNDED:
            return MIPResult(SolveStatus.UNBOUNDED, -np.inf, None)
        if r.status == SolveStatus.ITERATION_LIMIT:
            return MIPResult(SolveStatus.ITERATION_LIMIT, best_obj, best_x)
        bound = r.obj
        if integral_objective:
            bound = math.ceil(bound - INT_TOL)
        # prune: the subtree cannot strictly improve on the incumbent
        if bound >= best_obj - prune_eps:
            continue
        x = r.x
        frac = np.abs(x[int_idx] - np.rint(x[int_idx]))
        worst = int(np.argmax(frac)) if n_int else 0
        if n_int and frac[worst] > INT_TOL and _BRANCH_RULE != "mf":
            # cost-weighted branching (MOIP_BRANCH=costfrac): prefer the
            # fractional variable with the largest objective leverage —
            # measured to shrink correlated-knapsack trees vs pure
            # most-fractional
            fr = np.minimum(frac, 1.0 - np.minimum(frac, 1.0))
            cand = frac > INT_TOL
            w = np.abs(c[int_idx]) * (fr if _BRANCH_RULE == "costfrac" else 1.0)
            w = np.where(cand, w, -1.0)
            worst = int(np.argmax(w))
        if n_int == 0 or frac[worst] <= INT_TOL:
            # integer feasible
            obj = r.obj
            if obj < best_obj - INT_TOL:
                best_obj = obj
                best_x = x.copy()
            continue

        # rounding heuristic: snap the LP point to integers and keep it if
        # it is feasible and improving; polish new incumbents by 1-swap
        # local search (solver/heuristics.py) while the budget lasts
        for cand_vals in (np.rint(x[int_idx]), np.floor(x[int_idx] + INT_TOL)):
            cand = x.copy()
            cand[int_idx] = np.clip(cand_vals, node_lo[int_idx], node_hi[int_idx])
            v = check_candidate(ws, c, lo_full, hi_full, cand)
            if v is None:
                continue
            if ls_budget > 0:
                ls_budget -= 1
                cand, v = local_search(
                    ws.W[:, : ws.n], c, lo, hi, cand, int_idx
                )
            if v < best_obj - INT_TOL:
                best_obj = v
                best_x = cand.copy()

        if bound >= best_obj - prune_eps:
            continue

        # reduced-cost fixing: a nonbasic integer variable whose reduced
        # cost exceeds the remaining optimality gap cannot leave its bound
        # in any improving solution — pin it for the whole subtree
        child_lo = node_lo.copy()
        child_hi = node_hi.copy()
        if r.d is not None and int_idx.size:
            margin = best_obj - (1.0 if integral_objective else 0.0) - r.obj + INT_TOL
            if np.isfinite(margin):
                dx = r.d[: ws.n][int_idx]
                nb = ~r.in_basis[: ws.n][int_idx]
                up_nb = r.at_upper[: ws.n][int_idx]
                fix_at_lo = nb & ~up_nb & (dx > margin)
                fix_at_hi = nb & up_nb & (-dx > margin)
                if fix_at_lo.any():
                    ids = int_idx[fix_at_lo]
                    child_hi[ids] = np.rint(x[ids])
                    child_lo[ids] = np.rint(x[ids])
                if fix_at_hi.any():
                    ids = int_idx[fix_at_hi]
                    child_lo[ids] = np.rint(x[ids])
                    child_hi[ids] = np.rint(x[ids])

        j = int(int_idx[worst])
        v = x[j]
        fl = math.floor(v + INT_TOL)
        cwb = cwa = None
        if r.in_basis is not None:
            cwb = np.flatnonzero(r.in_basis)
            if cwb.shape[0] == ws.m and r.at_upper is not None:
                cwa = r.at_upper.copy()
            else:
                cwb = None
        dn = (child_lo.copy(), _set(child_hi, j, fl), cwb, cwa)
        up = (_set(child_lo, j, fl + 1), child_hi.copy(), cwb, cwa)
        # DFS toward the LP value: explore the nearer child first (on top)
        if v - fl > 0.5:
            stack.append(dn)
            stack.append(up)
        else:
            stack.append(up)
            stack.append(dn)

    if best_x is None:
        return MIPResult(SolveStatus.INFEASIBLE, np.nan, None)
    if integral_objective:
        best_obj = float(np.rint(best_obj))
    return MIPResult(SolveStatus.OPTIMAL, best_obj, best_x)


def _set(arr: np.ndarray, j: int, v: float) -> np.ndarray:
    out = arr.copy()
    out[j] = v
    return out


def _root_cut_loop(
    ws: SimplexWorkspace,
    c: np.ndarray,
    lo: np.ndarray,
    hi: np.ndarray,
    is_int: np.ndarray,
    max_rounds: int = 10,
):
    """Cut-and-branch root strengthening: separate extended cover cuts at
    the root LP optimum, append them as rows, re-solve, repeat until no
    violated cut remains.  Returns (ws', lo', hi') with the cut rows added.

    Validity is node-independent: separation sees the ROOT bounds, so every
    cut holds throughout the tree.  Cut rows are priced by the exact
    simplex like any other row — the exactness contract is untouched.
    """
    from moip_aira_tpu_torch.solver.cuts import separate_cover_cuts

    n, m0 = ws.n, ws.m
    A = ws.W[:, :n].copy()
    lo_c, hi_c = lo.copy(), hi.copy()
    added = 0
    for _ in range(max_rounds):
        r = solve_lp(ws, c, lo_c, hi_c)
        if r.status != SolveStatus.OPTIMAL or r.x is None:
            break
        fr = np.abs(r.x[is_int] - np.rint(r.x[is_int]))
        if fr.size == 0 or fr.max() <= INT_TOL:
            break
        cuts = separate_cover_cuts(
            A[:m0],  # separate from ORIGINAL rows only (cuts don't re-seed)
            lo_c[n : n + m0],
            hi_c[n : n + m0],
            r.x,
            lo_c,
            hi_c,
            is_int,
        )
        if not cuts:
            break
        rows = np.stack([cu[0] for cu in cuts])
        A = np.vstack([A, rows])
        lo_c = np.concatenate([lo_c, np.array([cu[1] for cu in cuts])])
        hi_c = np.concatenate([hi_c, np.array([cu[2] for cu in cuts])])
        ws = SimplexWorkspace(A)
        added += len(cuts)
    return ws, lo_c, hi_c

"""Combinatorial court — exact matching bounds for assignment-family nodes.

The audit's host tail (records whose f32 device claims fail their f64
certificates, _flush_host_queue in solver/wave.py) was the 2AP40 scaling
wall: ~10k exact LPs per solve at ~30 ms each (measured round 4).  Most of
those nodes are assignment sub-boxes whose phase-1 LP stalls on massive
degeneracy — but over the ASSIGNMENT polytope those questions have exact
combinatorial answers that cost a ~50 us Hungarian solve instead:

  For the relaxation that keeps only the equality (assignment) rows and the
  node's variable box, the LP feasible set is the restricted Birkhoff
  polytope: its vertices are the permutation matrices honouring the node's
  forced (lo >= 1) and forbidden (hi <= 0) cells.  Hence, EXACTLY:

  * the node LP (and a fortiori the MIP) is infeasible when no perfect
    matching honours the fixings                        [Birkhoff]
  * min over the polytope of ANY linear cost equals the min-cost perfect
    matching value — integral data, so the f64 sum is exact  [TU]

  Every such value is a bound for the TRUE node (whose LP adds the
  objective-bound rows, i.e. is a subset): min-cost >= node min is a valid
  dual bound, and "min of a bounded row's activity exceeds its upper
  bound" proves the node empty.  Nothing here trusts a float tolerance:
  costs are integers, matchings are integral, sums are exact in f64.

Reference analogue: CPLEX's network-structure extraction inside CPXmipopt
(src/aira.cpp:480-487) — the reference gets its assignment-polytope
shortcuts from the solver black box; here the court is explicit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

#: forbidden-cell sentinel: > any real |cost| * N in the bundled families
#: (integer costs, |c| <= ~1e4, N <= ~1e3) while N * BIG stays exact in f64
BIG = 2.0**40


class MatchCourt:
    """Per-backend court for one detected assignment structure.

    ``struct`` is heuristics._AssignStruct; ``A_full`` the (m, n) stacked
    row matrix (structural + objective rows); rows are judged against the
    task's logical bounds at judge() time.
    """

    def __init__(self, struct, A_full: np.ndarray):
        self.struct = struct
        self.A_full = np.asarray(A_full, dtype=np.float64)
        self.NA = struct.sideA.size
        self.NB = struct.sideB.size
        self.square = self.NA == self.NB
        self.n = struct.colA.shape[0]
        # BIG-sentinel soundness guard (advisor, round 4): min_cost treats
        # any selected cell >= BIG/2 as forbidden, which is only sound when
        # no REAL matching sum can reach that range.  Disable the court
        # outright unless max|data| * N stays far below the sentinel; judge
        # re-checks each task's cost vector the same way.
        data_max = float(np.abs(self.A_full).max()) if self.A_full.size else 0.0
        self.usable = (
            self.square and data_max * max(self.NA, 1) < BIG / 4
        )
        self.stats = {"judged": 0, "infeasible": 0, "pruned": 0,
                      "solved": 0, "open": 0, "unsafe_cost": 0}

    # -- core exact primitive ------------------------------------------------
    def min_cost(
        self, cost: np.ndarray, nlo: np.ndarray, nhi: np.ndarray
    ) -> Tuple[Optional[float], Optional[np.ndarray]]:
        """Exact min of cost.x over the node's restricted Birkhoff polytope.

        Returns (value, x) with x the attaining permutation (0/1 vector over
        the n structural variables), or (None, None) when the node admits NO
        perfect matching — which proves the node LP infeasible.
        """
        if not self.usable:
            # (None, None) means "proved empty" to callers — an unusable
            # court must never reach here; judge() gates on .usable
            raise ValueError("MatchCourt is not usable for this structure")
        if float(np.abs(cost[: self.n]).max(initial=0.0)) * self.NA >= BIG / 4:
            raise ValueError("cost magnitude would collide with the BIG sentinel")
        s = self.struct
        M = np.full((self.NA, self.NB), BIG)
        allowed = nhi[: self.n] > 0.5
        M[s.colA[allowed], s.colB[allowed]] = cost[: self.n][allowed]
        forced = nlo[: self.n] > 0.5
        fj = np.flatnonzero(forced)
        if fj.size:
            ra, cb = s.colA[fj], s.colB[fj]
            if len(set(ra.tolist())) != fj.size or len(set(cb.tolist())) != fj.size:
                return None, None  # two forced cells share a line: empty
            keep = M[ra, cb].copy()
            if np.any(keep >= BIG / 2):
                return None, None  # forced cell also forbidden: empty
            M[ra, :] = BIG
            M[:, cb] = BIG
            M[ra, cb] = keep
        from scipy.optimize import linear_sum_assignment

        ri, ci = linear_sum_assignment(M)
        total = M[ri, ci]
        if np.any(total >= BIG / 2):
            return None, None  # some row only had forbidden cells
        x = np.zeros(self.n)
        x[s.pair2col[ri, ci]] = 1.0
        return float(total.sum()), x

    # -- the judgement -------------------------------------------------------
    def judge(self, task, nlo, nhi, int_tol: float = 1e-6):
        """Try to close a host record without an LP.

        Returns one of
          ("infeasible",)          — node rigorously empty
          ("pruned", pb)           — rigorous bound pb >= incumbent
          ("solved", val, x)       — attaining matching is feasible for the
                                     FULL node: exact optimum, adopt + close
          None                     — court cannot close it; run the LP
        ``task`` provides cvec (sign-folded MIN objective), llo/lhi
        (logical row bounds), best (incumbent value), obj_int.
        """
        if not self.usable:
            return None
        if (
            float(np.abs(task.cvec[: self.n]).max(initial=0.0)) * self.NA
            >= BIG / 4
        ):
            # a caller-supplied cost this large would collide with the
            # forbidden-cell sentinel: refuse to judge, run the exact LP
            self.stats["unsafe_cost"] += 1
            return None
        self.stats["judged"] += 1
        eps = int_tol if task.obj_int else 1e-9
        val, x = self.min_cost(task.cvec, nlo, nhi)
        if val is None:
            self.stats["infeasible"] += 1
            return ("infeasible",)
        pb = float(np.ceil(val - int_tol)) if task.obj_int else val
        if pb >= task.best - eps:
            self.stats["pruned"] += 1
            return ("pruned", pb)
        # objective/inequality-row emptiness tests: a bounded row whose
        # best attainable activity still violates the bound proves the
        # node empty (each test = one exact matching on +-A_full[r])
        s = self.struct
        for r in s.ineq_rows:
            u = task.lhi[r]
            l = task.llo[r]
            row = self.A_full[r]
            if np.isfinite(u):
                vmin, _ = self.min_cost(row, nlo, nhi)
                if vmin is None:
                    self.stats["infeasible"] += 1
                    return ("infeasible",)
                if vmin > u + eps:
                    self.stats["infeasible"] += 1
                    return ("infeasible",)
            if np.isfinite(l):
                vneg, _ = self.min_cost(-row, nlo, nhi)
                if vneg is None:
                    self.stats["infeasible"] += 1
                    return ("infeasible",)
                if -vneg < l - eps:
                    self.stats["infeasible"] += 1
                    return ("infeasible",)
        # does the bound-attaining matching satisfy the FULL node?  Then the
        # node is SOLVED exactly: val is both a lower bound and attained.
        act = self.A_full @ x
        if (
            np.all(act >= task.llo - eps) and np.all(act <= task.lhi + eps)
            and np.all(x >= nlo[: self.n] - eps)
            and np.all(x <= nhi[: self.n] + eps)
        ):
            self.stats["solved"] += 1
            return ("solved", float(task.cvec[: self.n] @ x), x)
        # Lagrangian court (round 5): the plain matching bound ignores the
        # objective-bound rows, so nodes whose box BINDS stay "open" and
        # fall to a ~10-20 ms exact LP — measured 51% of judged records on
        # 2AP20, and the resulting lockstep LP batch was 55% of the whole
        # 2AP40 wall.  For each bound row the attaining matching violates,
        # fold it into the cost with a small dyadic multiplier grid: every
        # blend is still an exact min-cost matching over integral data
        # (mu dyadic => f64 sums exact), hence
        #   min cvec.x >= match_min(cvec + mu*row) - mu*u   (row.x <= u)
        #   min cvec.x >= match_min(cvec - mu*row) + mu*l   (row.x >= l)
        # — rigorous prunes exactly like kp_bb's per-node dual-min grid.
        for r in s.ineq_rows:
            row = self.A_full[r]
            a_r = float(act[r])
            u = task.lhi[r]
            l = task.llo[r]
            over = np.isfinite(u) and a_r > u + eps
            under = np.isfinite(l) and a_r < l - eps
            if not (over or under):
                continue
            if (
                float(np.abs(row[: self.n]).max(initial=0.0)) * 4.0 * self.NA
                >= BIG / 8
            ):
                continue  # blend would near the sentinel: leave to the LP
            for mu in (0.25, 0.5, 1.0, 2.0, 4.0):
                if over:
                    cost = task.cvec[: self.n] + mu * row[: self.n]
                    off = -mu * float(u)
                else:
                    cost = task.cvec[: self.n] - mu * row[: self.n]
                    off = mu * float(l)
                bval, bx = self.min_cost(cost, nlo, nhi)
                if bval is None:
                    self.stats["infeasible"] += 1
                    return ("infeasible",)
                lb = bval + off
                pb = float(np.ceil(lb - int_tol)) if task.obj_int else lb
                if pb >= task.best - eps:
                    self.stats["pruned"] += 1
                    return ("pruned", pb)
                # complementary slackness: a blend-attaining matching that
                # is feasible for the FULL node and tight on row r proves
                # itself optimal (its cvec value equals the valid bound)
                bact = self.A_full @ bx
                tight = (
                    abs(bact[r] - (u if over else l)) <= eps
                )
                if (
                    tight
                    and np.all(bact >= task.llo - eps)
                    and np.all(bact <= task.lhi + eps)
                    and np.all(bx >= nlo[: self.n] - eps)
                    and np.all(bx <= nhi[: self.n] + eps)
                ):
                    self.stats["solved"] += 1
                    return (
                        "solved", float(task.cvec[: self.n] @ bx), bx
                    )
        self.stats["open"] += 1
        return None

"""Exact combinatorial engine for the multi-constraint knapsack family.

The reference solves its KP2D family (two capacity rows; Timing.ods KP2D
sheet) through CPLEX, whose knapsack cover cuts + presolve carry the
hardness (src/aira.cpp:480-487).  The rebuilt LP-based branch-and-bound has
no such cut stack and drowns: measured KP2D50 = 375 s on the host oracle
(~5.3 s per lex IP) vs the reference's 1.0 s TOTAL.  The LP relaxation is
simply the wrong bound for near-uniform-weight knapsacks.

This module replaces the LP entirely for the family with the classical
surrogate-relaxation attack (Gavish & Pirkul's multidimensional-knapsack
method, re-expressed), plus exact-DP variable pegging:

* each lex-stage IP is canonicalised to
      max v.x   s.t.  W x <= b (capacity rows, nonneg int)
                      V x >= d (cover rows: objective bounds / row lbs)
                      x in {0,1}^n
* capacities fold into ONE surrogate row  ws = mu1 w1 + mu2 w2  (small
  nonneg integer multipliers) and cover rows into the profit via nonneg
  rational Lagrange multipliers  q = B*v + sum_l a_l V_l — both are
  RELAXATIONS, so any (mu, a) yields a rigorous upper bound; the
  multipliers only tune tightness and are picked by a cheap fractional
  greedy search per IP;
* branching follows the q/ws ratio order, so every node's free set is a
  SUFFIX of the order and its bound is an O(1) lookup into precomputed
  suffix dynamic programs: F[k][c] (surrogate row), Fcap[r][k][c] (each
  original capacity row — same order, independently valid), with the MIN
  of all of them as the node bound — the surrogate subproblem solved as
  an INTEGER program dominates the LP bound of the original (surrogate
  duality);
* cover feasibility prunes through G_l[k][c] = max V_l over the suffix
  under the surrogate capacity;
* when a budgeted first dive leaves the IP open, items are PEGGED by the
  exact prefix+suffix argument (Dembo-Hammer reduction with DP bounds):
  forcing item i in/out bounds the whole problem by
  max_c P[i][c] + F[i+1][C - c] (+ q_i), and any item whose forced bound
  cannot beat the incumbent is fixed for the rest of the search — the
  surviving free "core" is typically a small fraction of n and the
  restarted search closes in thousands of nodes where the naive tree
  burned millions.

Everything that feeds a prune/accept/peg decision is exact int64
arithmetic (profits, weights and multiplier numerators are integers;
bounds are floor-divided); no tolerance anywhere.  The exactness
invariant holds without any f64 LP certification because there is no LP.

Where it plugs in: ``KnapsackLexBackend`` is a drop-in lex backend
(api.make_backend routes the detected family to it under ``auto``);
``detect_kp_family`` is deliberately conservative — binary variables,
one-sided nonneg-integer structural rows, uniformly signed integer
objectives — everything else keeps the general engine.
"""

from __future__ import annotations

import bisect
import dataclasses
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from moip_aira_tpu_torch.problem import Problem
from moip_aira_tpu_torch.sense import INF, Sense
from moip_aira_tpu_torch.solver.lex import LexOutcome, LexRequest
from moip_aira_tpu_torch.solver.status import SolveStatus

#: denominator for rationalised cover multipliers (q = LAM_DEN*v + a.V)
LAM_DEN = 16

#: multiplier grid for the per-node dual-min bound on single-cover IPs
#: (numerators over LAM_DEN, i.e. lambda in {0, 1/8, 1/4, 3/8, 1/2, 3/4, 1})
MULTI_A = (0, 2, 4, 8, 12, 16)

#: surrogate-multiplier candidates tried per IP (per capacity-row pair);
#: single-cap problems use (1,)
MU_CANDIDATES_2 = ((1, 1), (1, 0), (0, 1), (2, 1), (1, 2), (3, 2), (2, 3))

#: suffix-DP table budget (bytes) — beyond it the engine falls back to the
#: O(log n) fractional Dantzig suffix bound (still exact as a bound)
TABLE_BUDGET = 512 * 2**20

#: nodes granted to the first dive before pegging kicks in
FIRST_BUDGET = 4_000

#: hard node ceiling per IP — a blown ceiling raises and the caller falls
#: back to the general engine; nothing is silently truncated
NODE_LIMIT = 50_000_000

#: incumbent-pool width kept by the backend across lex IPs
POOL_CAP = 256


class NodeLimitExceeded(RuntimeError):
    pass


class _BudgetExceeded(Exception):
    """Internal: the budgeted first dive did not close the IP."""


@dataclasses.dataclass
class KPFamily:
    """Canonical max-form family data (all int64, all nonnegative).

    ``mirror`` is True when the original problem minimises nonpositive
    objectives (the reference .mop convention): objective values negate on
    the way out and objective-bound rhs negate on the way in.
    """

    W: np.ndarray  # (n_caps, n) capacity rows
    b: np.ndarray  # (n_caps,) capacities
    V: np.ndarray  # (objcnt, n) objective value rows (max form)
    extra_V: np.ndarray  # (n_extra, n) structural cover rows
    extra_d: np.ndarray  # (n_extra,) their minimum activities
    mirror: bool


def detect_kp_family(problem: Problem) -> Optional[KPFamily]:
    """Canonicalise ``problem`` to the knapsack family, or return None.

    Accepts: all variables binary; every structural row one-sided with
    uniformly-signed integer data (nonneg '<=' = capacity, nonneg '>='
    = cover; the mirrored nonpos forms likewise); objectives integer and
    uniformly nonneg under MAX or nonpos under MIN.  Two-sided (equality)
    structural rows are rejected — that is the assignment family's shape
    and the wave engine + matching court own it.
    """
    p = problem
    if p.objcnt < 2 or p.n == 0:
        return None
    if not bool(np.all(p.is_int)):
        return None
    if not (np.all(p.lb == 0) and np.all(p.ub == 1)):
        return None
    C = np.asarray(p.C, dtype=np.float64)
    if not np.all(C == np.rint(C)):
        return None
    if p.objsen is Sense.MAX and np.all(C >= 0):
        V = np.rint(C).astype(np.int64)
        mirror = False
    elif p.objsen is Sense.MIN and np.all(C <= 0):
        V = np.rint(-C).astype(np.int64)
        mirror = True
    else:
        return None
    caps_w: List[np.ndarray] = []
    caps_b: List[int] = []
    cov_v: List[np.ndarray] = []
    cov_d: List[int] = []
    for r in range(p.m_struct):
        a = np.asarray(p.A[r], dtype=np.float64)
        if not np.all(a == np.rint(a)):
            return None
        lb, ub = float(p.row_lb[r]), float(p.row_ub[r])
        if np.isfinite(lb) and np.isfinite(ub):
            return None  # two-sided row: not this family
        if np.all(a >= 0):
            w = np.rint(a).astype(np.int64)
            if np.isfinite(ub):
                caps_w.append(w)
                caps_b.append(int(np.floor(ub)))
            elif np.isfinite(lb) and lb > 0:
                cov_v.append(w)
                cov_d.append(int(np.ceil(lb)))
        elif np.all(a <= 0):
            w = np.rint(-a).astype(np.int64)
            if np.isfinite(lb):
                # a.x >= lb  <=>  w.x <= -lb
                caps_w.append(w)
                caps_b.append(int(np.floor(-lb)))
            elif np.isfinite(ub) and ub < 0:
                cov_v.append(w)
                cov_d.append(int(np.ceil(-ub)))
        else:
            return None  # mixed-sign row: not a knapsack row
    if not caps_w:
        return None
    for bi in caps_b:
        if bi < 0:
            return None
    if len(caps_w) > 4:
        return None
    return KPFamily(
        W=np.stack(caps_w),
        b=np.asarray(caps_b, dtype=np.int64),
        V=V,
        extra_V=(
            np.stack(cov_v) if cov_v else np.zeros((0, p.n), dtype=np.int64)
        ),
        extra_d=np.asarray(cov_d, dtype=np.int64),
        mirror=mirror,
    )


def _greedy_ub(q: np.ndarray, ws: np.ndarray, cap: int) -> float:
    """Fractional Dantzig bound max q.x s.t. ws.x <= cap (selection only)."""
    pos = q > 0
    if not np.any(pos):
        return 0.0
    qp, wp = q[pos].astype(np.float64), ws[pos].astype(np.float64)
    order = np.argsort(-qp / np.maximum(wp, 1e-12))
    qp, wp = qp[order], wp[order]
    cw = np.cumsum(wp)
    fit = cw <= cap
    val = float(qp[fit].sum())
    k = int(fit.sum())
    if k < qp.shape[0]:
        rest = cap - (cw[k - 1] if k else 0.0)
        if wp[k] > 0:
            val += qp[k] * rest / wp[k]
        else:
            val += qp[k]
    return val


def _suffix_dp(val: np.ndarray, ws: np.ndarray, Cs: int) -> np.ndarray:
    """F[k][c] = max val over items k.. with total ws <= c (exact int32:
    blended profits stay < 2^22 for the bundled families — asserted).

    One preallocated (n+1, Cs+1) block: building tables as lists of fresh
    per-row arrays thrashed the allocator (measured: ndarray.copy was half
    the KP2D100 ladder)."""
    n = val.shape[0]
    assert int(np.abs(val).sum()) < 2**31 - 1, "profit sum overflows int32"
    F = np.empty((n + 1, Cs + 1), dtype=np.int32)
    F[n] = 0
    for k in range(n - 1, -1, -1):
        prev = F[k + 1]
        cur = F[k]
        cur[:] = prev
        w, qv = int(ws[k]), int(val[k])
        if w <= Cs:
            take = prev[: Cs + 1 - w] + qv
            np.maximum(cur[w:], take, out=cur[w:])
    return F


def _prefix_dp(val: np.ndarray, ws: np.ndarray, Cs: int) -> np.ndarray:
    """P[k][c] = max val over items 0..k-1 with total ws <= c."""
    n = val.shape[0]
    assert int(np.abs(val).sum()) < 2**31 - 1, "profit sum overflows int32"
    P = np.empty((n + 1, Cs + 1), dtype=np.int32)
    P[0] = 0
    for k in range(n):
        prev = P[k]
        cur = P[k + 1]
        cur[:] = prev
        w, qv = int(ws[k]), int(val[k])
        if w <= Cs:
            take = prev[: Cs + 1 - w] + qv
            np.maximum(cur[w:], take, out=cur[w:])
    return P


class _Tables:
    """Ratio-sorted instance + suffix DP tables for one (q, mu) choice.

    Arrays come in pre-canonicalised (possibly a reduced core); ``cols``
    maps sorted positions back to ORIGINAL problem columns.  ``F`` bounds
    q over the surrogate row; ``Fcap[r]`` bounds q over each original
    capacity row (valid in the same branch order — a suffix DP doesn't
    care how the suffix was ordered), so a node's rigorous bound is the
    MIN over all of them."""

    __slots__ = (
        "cols", "q", "ws", "W", "V", "v", "b", "F", "Fcap", "G", "Cs",
        "dp", "qpre", "wpre", "mu", "n", "multi",
    )

    def __init__(
        self,
        v: np.ndarray,
        a: np.ndarray,
        Vall: np.ndarray,
        mu: Tuple[int, ...],
        W: np.ndarray,
        b: np.ndarray,
        cols: Optional[np.ndarray] = None,
    ):
        n = v.shape[0]
        self.n = n
        self.mu = mu
        q = LAM_DEN * v + (a @ Vall if a.size else 0)
        ws = np.zeros(n, dtype=np.int64)
        Cs = 0
        for mi, wrow, bi in zip(mu, W, b):
            if mi:
                ws += mi * wrow
                Cs += mi * int(bi)
        ratio = q / np.maximum(ws, 1)
        # zero-weight items with positive q are free improvements: first
        ratio = np.where((ws == 0) & (q > 0), np.inf, ratio)
        order = np.lexsort((ws, -ratio))
        if cols is None:
            cols = np.arange(n)
        self.cols = cols[order]
        self.q = q[order]
        self.ws = ws[order]
        self.W = W[:, order]
        self.V = Vall[:, order]
        self.v = v[order]
        self.b = b.copy()
        self.Cs = Cs
        ncov_all = Vall.shape[0]
        cells = (n + 1) * ((Cs + 1) * (1 + ncov_all) + int((b + 1).sum()))
        self.dp = cells * 4 <= TABLE_BUDGET
        self.multi = []
        if self.dp:
            self.F = _suffix_dp(self.q, self.ws, Cs)
            self.Fcap = [
                _suffix_dp(self.q, self.W[r], int(b[r]))
                for r in range(W.shape[0])
            ]
            self.G = [
                _suffix_dp(self.V[l], self.ws, Cs) for l in range(ncov_all)
            ]
        else:
            # fractional-bound fallback: suffix prefix-sums in ratio order
            self.qpre = np.concatenate([[0], np.cumsum(self.q)])
            self.wpre = np.concatenate([[0], np.cumsum(self.ws)])
            self.F = None
            self.Fcap = None
            self.G = None

    def ensure_multi(self) -> None:
        """Build the dual-min multiplier grid (single-cover IPs) LAZILY.

        One lambda's bound has a pointwise plateau (measured KP2D200
        d=8495: root gap 26 yet 7M nodes); the per-node dual min over a
        small multiplier grid prunes where any single table cannot — each
        table is a valid relaxation over the SAME branch order.  Building
        the grid eagerly taxed every easy IP with ~6 table builds
        (KP2D100 ladder 3.3 s -> 6.0 s), so it happens only when an IP
        survives its budgeted first dive."""
        if self.multi or not self.dp or self.V.shape[0] != 1:
            return
        n = self.n
        multi_cells = (len(MULTI_A) + 1) * (n + 1) * (self.Cs + 1)
        if multi_cells * 4 > TABLE_BUDGET:
            return
        for a_s in MULTI_A:
            qa = LAM_DEN * self.v + a_s * self.V[0]
            self.multi.append((a_s, _suffix_dp(qa, self.ws, self.Cs)))

    def traceback(self) -> List[int]:
        """One surrogate-optimal take-set (sorted positions), from F."""
        if not self.dp:
            return []
        sel: List[int] = []
        c = self.Cs
        F = self.F
        for k in range(self.n):
            w = int(self.ws[k])
            if w <= c and F[k][c] == int(self.q[k]) + F[k + 1][c - w]:
                sel.append(k)
                c -= w
        return sel


class KPIPSolver:
    """Exact branch-and-bound for ONE canonical knapsack IP.

    maximize v.x  s.t.  W x <= b,  V_cov x >= d_cov,  x binary.
    """

    def __init__(self, fam: KPFamily, tables_cache: Dict):
        self.fam = fam
        self.cache = tables_cache
        self.nodes = 0
        self.pegged = 0

    # -- multiplier selection (floats; selection only, never a bound) -----
    def _pick(self, v, cov_V, cov_d):
        fam = self.fam
        ncap = fam.W.shape[0]
        mus = MU_CANDIDATES_2 if ncap == 2 else (
            ((1,),) if ncap == 1 else (tuple([1] * ncap),)
        )
        best = None
        for mu in mus:
            ws = np.zeros(fam.W.shape[1], dtype=np.int64)
            cap = 0
            for mi, wrow, bi in zip(mu, fam.W, fam.b):
                ws = ws + mi * wrow
                cap += mi * int(bi)
            lam = np.zeros(len(cov_d), dtype=np.float64)
            # near-equality covers (the ladder's far-end boxes) need LARGE
            # multipliers before the greedy set honours them: let the
            # doubling search reach lambda ~512
            for _ in range(13):
                q = v + (lam @ cov_V if lam.size else 0)
                ub = _greedy_ub(q, ws, cap) - float(
                    lam @ cov_d if lam.size else 0.0
                )
                if best is None or ub < best[0]:
                    best = (ub, mu, lam.copy())
                if not lam.size:
                    break
                # push multipliers toward violated covers of the greedy set
                viol = self._greedy_violation(q, ws, cap, cov_V, cov_d)
                if viol is None:
                    break
                lam[viol] = max(lam[viol] * 2.0, 0.25)
        _, mu, lam = best
        a = np.rint(lam * LAM_DEN).astype(np.int64)
        return mu, a

    def _greedy_violation(self, q, ws, cap, cov_V, cov_d):
        pos = np.flatnonzero(q > 0)
        if pos.size == 0:
            x = np.zeros(q.shape[0], dtype=bool)
        else:
            order = pos[np.argsort(-(q[pos] / np.maximum(ws[pos], 1e-12)))]
            cw = np.cumsum(ws[order])
            x = np.zeros(q.shape[0], dtype=bool)
            x[order[cw <= cap]] = True
        slack = (cov_V @ x) - cov_d if len(cov_d) else np.zeros(0)
        if slack.size and slack.min() < 0:
            return int(np.argmin(slack))
        return None

    # -- the exact solve ---------------------------------------------------
    def solve(
        self,
        j: int,
        cov_rows: Sequence[int],
        cov_d: Sequence[int],
        x_hint: Optional[np.ndarray] = None,
        pool: Optional[np.ndarray] = None,
    ):
        """Maximise objective ``j`` (row of fam.V) under covers
        ``fam.V[cov_rows] >= cov_d`` plus the family's structural covers.

        ``pool`` is a (p, n) 0/1 matrix of feasible-for-SOME-box points
        collected by the backend; feasible members seed the incumbent.
        Returns (opt_value, x 0/1 ndarray) or (None, None) if infeasible.
        """
        fam = self.fam
        n = fam.V.shape[1]
        v = fam.V[j]
        # full cover set: requested objective covers + structural covers
        all_V = (
            np.vstack([fam.V[list(cov_rows)], fam.extra_V])
            if (len(cov_rows) or fam.extra_V.shape[0])
            else np.zeros((0, n), dtype=np.int64)
        )
        all_d = np.concatenate(
            [np.asarray(cov_d, dtype=np.int64), fam.extra_d]
        )
        mu, a = self._pick(
            v.astype(np.float64),
            all_V.astype(np.float64),
            all_d.astype(np.float64),
        )
        # NOTE the tuned `a` stays: it sets the BRANCHING ORDER (tab.q's
        # ratio sort), and pinning it to a constant was measured to double
        # the whole KP2D200 ladder even with the dual grid active — order
        # quality beats table-cache hit rate.
        # cov_rows is part of the key: it determines all_V's CONTENT, which
        # both the Lagrangian profit q and every G table depend on
        key = (j, mu, tuple(a.tolist()), tuple(cov_rows))
        tab = self.cache.get(key)
        if tab is None:
            tab = _Tables(v, a, all_V, mu, fam.W, fam.b)
            while len(self.cache) > 16:
                # oldest-entry eviction: clear-all thrashed when the two
                # workers' live key set hovered at the cap
                self.cache.pop(next(iter(self.cache)))
            self.cache[key] = tab
        else:
            # LRU touch (dict preserves insertion order)
            self.cache.pop(key)
            self.cache[key] = tab
        lam_d = int(a @ all_d) if a.size else 0

        # ---- incumbent seeding (original column space) -------------------
        best_v = -1
        best_x: Optional[np.ndarray] = None

        def consider(x01: np.ndarray):
            nonlocal best_v, best_x
            if (
                np.all(fam.W @ x01 <= fam.b)
                and (all_d.size == 0 or np.all(all_V @ x01 >= all_d))
            ):
                val = int(v @ x01)
                if val > best_v:
                    best_v = val
                    best_x = x01.astype(np.float64)

        if x_hint is not None:
            xh = np.rint(np.asarray(x_hint, dtype=np.float64)).astype(
                np.int64
            )
            if np.all(xh >= 0) and np.all(xh <= 1):
                consider(xh)
        if pool is not None and pool.shape[0]:
            # vectorised feasibility over the whole pool, best value wins
            okc = np.all(pool @ fam.W.T <= fam.b, axis=1)
            if all_d.size:
                okc &= np.all(pool @ all_V.T >= all_d, axis=1)
            if okc.any():
                vals = pool[okc] @ v
                consider(pool[okc][int(np.argmax(vals))].astype(np.int64))
        sel = tab.traceback()
        if sel:
            xt = np.zeros(n, dtype=np.int64)
            xt[tab.cols[sel]] = 1
            consider(xt)

        # ---- budgeted dive, then peg + restart ---------------------------
        best_v, best_x, done = self._search(
            tab, all_d, lam_d, best_v, best_x, FIRST_BUDGET
        )
        if not done:
            # hard IP: arm the dual-min grid, peg against the dive-improved
            # incumbent, restart on the core
            tab.ensure_multi()
            tab2, base = self._peg(tab, all_d, lam_d, best_v)
            if tab2 is None:
                # pegging couldn't shrink the core: finish on the full tree
                best_v, best_x, _ = self._search(
                    tab, all_d, lam_d, best_v, best_x, NODE_LIMIT
                )
            else:
                base_cols, base_v, d_red = base
                rb = best_v - base_v  # reduced-space incumbent value
                lam_d_red = int(a @ d_red) if a.size else 0
                rv, rx, _ = self._search(
                    tab2, d_red, lam_d_red, rb, None, NODE_LIMIT
                )
                if rv > rb and rx is not None:
                    best_v = rv + base_v
                    bx = rx.copy()
                    bx[base_cols] = 1.0
                    best_x = bx
        if best_x is None:
            return None, None
        # exact acceptance audit: the incumbent must satisfy every
        # constraint in integer arithmetic (defence in depth; a failure
        # here is a bug, not an input condition)
        xi = np.rint(best_x).astype(np.int64)
        assert np.all(fam.W @ xi <= fam.b), "kp_bb: capacity violation"
        if all_d.size:
            assert np.all(all_V @ xi >= all_d), "kp_bb: cover violation"
        assert int(v @ xi) == best_v, "kp_bb: objective mismatch"
        return best_v, best_x

    # -- exact-DP pegging (Dembo-Hammer reduction) -------------------------
    def _peg(self, tab: _Tables, all_d, lam_d: int, best_v: int):
        """Fix every item the exact prefix+suffix DPs prove decided.

        Two independent tests per item i:
          * OPTIMALITY: forcing i out (resp. in) bounds the whole problem
            by max_c P[i][c] + F[i+1][C-c] (+ q_i); below the incumbent
            target means no IMPROVING solution disagrees — fix it.
          * COVER FEASIBILITY: the max attainable cover-l activity WITHOUT
            item i (prefix+suffix cover DPs under the surrogate capacity)
            falling short of d_l means every FEASIBLE solution takes i.
        The second test is what bites on the epsilon-ladder's far-end
        boxes (cover d near the objective's max), where the Lagrangian
        bound is weakest — measured KP2D200: 14.8M-node IPs with 0 items
        pegged by the optimality test alone.

        Returns (reduced _Tables, (fixed1_original_cols, base_v, d_red))
        or (None, None) when the reduction leaves >85% of items free.
        """
        if not tab.dp or best_v < 0:
            return None, None
        n = tab.n
        Cs = tab.Cs
        F = tab.F
        P = _prefix_dp(tab.q, tab.ws, Cs)
        ncov = tab.V.shape[0]
        PG = [_prefix_dp(tab.V[l], tab.ws, Cs) for l in range(ncov)]
        target = LAM_DEN * best_v + lam_d  # beat this in q-units
        fix0 = np.zeros(n, dtype=bool)
        fix1 = np.zeros(n, dtype=bool)
        for i in range(n):
            w = int(tab.ws[i])
            Pi = P[i]
            Fi = F[i + 1]
            # forced OUT: prefix + suffix skip item i entirely
            ub0 = int(np.max(Pi + Fi[::-1]))
            if ub0 <= target:
                fix1[i] = True
                continue
            for l in range(ncov):
                cov_wo = int(np.max(PG[l][i] + tab.G[l][i + 1][::-1]))
                if cov_wo < int(all_d[l]):
                    fix1[i] = True
                    break
            if fix1[i]:
                continue
            # forced IN: item i consumes w of the surrogate capacity
            rc = Cs - w
            if rc < 0:
                fix0[i] = True
                continue
            ub1 = int(np.max(Pi[: rc + 1] + Fi[rc::-1])) + int(tab.q[i])
            if ub1 <= target:
                fix0[i] = True
        self.pegged += int(fix0.sum() + fix1.sum())
        free = ~(fix0 | fix1)
        if int(free.sum()) > 0.85 * n:
            return None, None
        # the capacity/cover state after committing the forced-in items
        w_used = tab.W[:, fix1].sum(axis=1)
        b_red = tab.b - w_used
        if np.any(b_red < 0):
            # forced-in set alone violates a capacity: no improving
            # solution exists; an empty reduced core makes _search return
            # the incumbent unchanged
            b_red = np.maximum(b_red, 0)
            free[:] = False
        d_red = all_d - tab.V[:, fix1].sum(axis=1)
        base_v = int(tab.v[fix1].sum())
        base_cols = tab.cols[fix1]
        # recompute the Lagrangian q on the reduced core with the SAME
        # multipliers (a is implicit in tab.q: q = LAM*v + a.V, linear, so
        # the reduced q is just the sliced q — rebuild via arrays)
        tab2 = _reduced_tables(tab, free, b_red)
        return tab2, (base_cols, base_v, d_red)

    # -- the DFS over one table set ---------------------------------------
    def _search(
        self,
        tab: _Tables,
        all_d: np.ndarray,
        lam_d: int,
        best_v_in: int,
        best_x_in: Optional[np.ndarray],
        budget: int,
    ):
        """Exact DFS; returns (best_v, best_x, complete) with best_x in
        ORIGINAL column space (via tab.cols).  ``complete`` is False when
        ``budget`` nodes were expanded without exhausting the tree (the
        partial incumbents are still returned); raises NodeLimitExceeded
        past the hard ceiling."""
        n = tab.n
        ncap = tab.W.shape[0]
        ncov = tab.V.shape[0]
        # python-int locals: the DFS is pure CPython, numpy scalars are slow
        q_l = tab.q.tolist()
        ws_l = tab.ws.tolist()
        W_l = [tab.W[r].tolist() for r in range(ncap)]
        V_l = [tab.V[l].tolist() for l in range(ncov)]
        v_l = tab.v.tolist()
        b_l = tab.b.tolist()
        d_l = all_d.tolist()
        Cs = tab.Cs
        F = tab.F
        Fcap = tab.Fcap
        G = tab.G
        dp = tab.dp
        cols = tab.cols
        multi = tab.multi if dp else []
        d0 = int(all_d[0]) if multi else 0
        if not dp:
            qpre = tab.qpre
            wpre = tab.wpre
            # suffix max-possible cover activity (no capacity refinement)
            Vsuf = [
                np.concatenate([np.cumsum(tab.V[l][::-1])[::-1], [0]]).tolist()
                for l in range(ncov)
            ]

        best_v = best_v_in
        best_x = best_x_in
        take = [0] * n
        used = [0] * ncap
        vacc_cov = [0] * ncov
        node_cap = min(budget, NODE_LIMIT)
        start_nodes = self.nodes
        hard = budget >= NODE_LIMIT
        LAMD = LAM_DEN

        def frac_bound(k: int, rc: int) -> int:
            """Integer upper bound on suffix q-value within rc (no-DP mode):
            Dantzig on the ratio-sorted suffix via prefix sums + bisect."""
            base_w = wpre[k]
            t = bisect.bisect_right(wpre, base_w + rc, lo=k, hi=n + 1) - 1
            val = int(qpre[t] - qpre[k])
            if t < n and ws_l[t] > 0:
                val += (rc - int(wpre[t] - base_w)) * q_l[t] // ws_l[t]
            return val

        def rec(k: int, us: int, qa: int, va: int):
            nonlocal best_v, best_x
            self.nodes += 1
            if self.nodes - start_nodes > node_cap:
                if hard:
                    raise NodeLimitExceeded(f"kp_bb node limit at depth {k}")
                raise _BudgetExceeded()
            rc = Cs - us
            # rigorous optimality bounds, tried cheapest-first with a
            # short-circuit: the surrogate-row bound, each capacity-row
            # bound, then (single-cover IPs) the dual grid — every one a
            # valid relaxation, so ANY of them pruning is sound, and most
            # nodes prune on the first or second lookup
            target = LAMD * best_v + LAMD - 1  # prune iff ub_num <= ...
            if dp:
                # int() on every table lookup: int32 numpy scalars mixed
                # with large Python ints (lam_d can exceed int32 on
                # unattainable covers) raise OverflowError otherwise
                if qa + int(F[k][rc]) - lam_d <= target:
                    return
                pruned = False
                for r in range(ncap):
                    if (
                        qa + int(Fcap[r][k][b_l[r] - used[r]]) - lam_d
                        <= target
                    ):
                        pruned = True
                        break
                if pruned:
                    return
                if multi:
                    base = LAMD * va
                    vc0 = vacc_cov[0]
                    for a_s, Fa in multi:
                        if base + a_s * (vc0 - d0) + int(Fa[k][rc]) <= target:
                            pruned = True
                            break
                    if pruned:
                        return
            else:
                if qa + frac_bound(k, rc) - lam_d <= target:
                    return
            # rigorous cover-feasibility bound
            for l in range(ncov):
                hi = int(G[l][k][rc]) if dp else int(Vsuf[l][k])
                if vacc_cov[l] + hi < d_l[l]:
                    return
            if k == n:
                for l in range(ncov):
                    if vacc_cov[l] < d_l[l]:
                        return
                if va > best_v:
                    best_v = va
                    bx = np.zeros(self.fam.V.shape[1], dtype=np.float64)
                    bx[[cols[i] for i in range(n) if take[i]]] = 1.0
                    best_x = bx
                return
            # child: take item k (capacity-feasible only)
            fits = True
            for r in range(ncap):
                if used[r] + W_l[r][k] > b_l[r]:
                    fits = False
                    break
            if fits:
                take[k] = 1
                for r in range(ncap):
                    used[r] += W_l[r][k]
                for l in range(ncov):
                    vacc_cov[l] += V_l[l][k]
                rec(k + 1, us + ws_l[k], qa + q_l[k], va + v_l[k])
                take[k] = 0
                for r in range(ncap):
                    used[r] -= W_l[r][k]
                for l in range(ncov):
                    vacc_cov[l] -= V_l[l][k]
            # child: skip item k
            rec(k + 1, us, qa, va)

        old = sys.getrecursionlimit()
        if old < n + 256:
            sys.setrecursionlimit(n + 512)
        complete = True
        try:
            rec(0, 0, 0, 0)
        except _BudgetExceeded:
            complete = False
        finally:
            sys.setrecursionlimit(old)
        return best_v, best_x, complete


def _reduced_tables(tab: _Tables, free: np.ndarray, b_red: np.ndarray):
    """Build _Tables for the free core of ``tab`` (same q/multipliers)."""
    sub = _Tables.__new__(_Tables)
    idx = np.flatnonzero(free)
    n = idx.shape[0]
    sub.n = n
    sub.mu = tab.mu
    # items keep tab's ratio order (idx ascends within it)
    sub.cols = tab.cols[idx]
    sub.q = tab.q[idx]
    sub.ws = tab.ws[idx]
    sub.W = tab.W[:, idx]
    sub.V = tab.V[:, idx]
    sub.v = tab.v[idx]
    sub.b = b_red.astype(np.int64)
    Cs = 0
    for mi, bi in zip(tab.mu, b_red):
        Cs += mi * int(bi)
    sub.Cs = Cs
    ncov = tab.V.shape[0]
    cells = (n + 1) * ((Cs + 1) * (1 + ncov) + int((b_red + 1).sum()))
    sub.dp = cells * 4 <= TABLE_BUDGET
    sub.multi = []
    if sub.dp:
        sub.F = _suffix_dp(sub.q, sub.ws, Cs)
        sub.Fcap = [
            _suffix_dp(sub.q, sub.W[r], int(b_red[r]))
            for r in range(sub.W.shape[0])
        ]
        sub.G = [_suffix_dp(sub.V[l], sub.ws, Cs) for l in range(ncov)]
        if tab.multi and ncov == 1:
            for a_s, _ in tab.multi:
                qa = LAM_DEN * sub.v + a_s * sub.V[0]
                sub.multi.append((a_s, _suffix_dp(qa, sub.ws, Cs)))
    else:
        sub.qpre = np.concatenate([[0], np.cumsum(sub.q)])
        sub.wpre = np.concatenate([[0], np.cumsum(sub.ws)])
        sub.F = None
        sub.Fcap = None
        sub.G = None
    return sub


class KnapsackLexBackend:
    """Lex backend: every stage IP solved by the combinatorial engine.

    Mirrors NumpyLexBackend.lex_solve's stage loop (solver/lex.py:75-110,
    itself reference aira.cpp:452-536): optimise the permutation's
    objectives in order, fixing each bound to the achieved optimum.
    """

    name = "kpbb"

    def __init__(self, problem: Problem, fam: Optional[KPFamily] = None):
        self.problem = problem
        self.fam = fam if fam is not None else detect_kp_family(problem)
        if self.fam is None:
            raise ValueError(f"{problem.filename}: not in the knapsack family")
        self._tables: Dict = {}
        self.ip_count = 0
        self._fallback = None
        #: rolling pool of optimal points from past IPs: strong warm
        #: incumbents for neighbouring boxes in the epsilon ladder
        self._pool = np.zeros((0, problem.n), dtype=np.int64)

    def _general_fallback(self):
        """Lazily-built general LP backend for the (never yet observed)
        case where an IP blows the combinatorial node ceiling."""
        if self._fallback is None:
            from moip_aira_tpu_torch.solver.lex import NumpyLexBackend

            self._fallback = NumpyLexBackend(self.problem)
        return self._fallback

    def _pool_add(self, x: np.ndarray):
        xi = np.rint(x).astype(np.int64)
        if self._pool.shape[0]:
            if np.any(np.all(self._pool == xi, axis=1)):
                return
        self._pool = np.vstack([self._pool, xi[None]])
        if self._pool.shape[0] > POOL_CAP:
            self._pool = self._pool[-POOL_CAP:]

    def lex_solve(self, req: LexRequest) -> LexOutcome:
        p = self.problem
        fam = self.fam
        k = p.objcnt
        solver = KPIPSolver(fam, self._tables)
        # canonical max-form cover rhs: MAX keeps rhs, mirrored MIN negates
        srhs = np.asarray(req.rhs, dtype=np.float64).copy()

        def cover_d() -> Tuple[List[int], List[int]]:
            rows: List[int] = []
            ds: List[int] = []
            for l in range(k):
                r = srhs[l]
                dval = -r if fam.mirror else r
                if dval == -INF or not np.isfinite(dval):
                    continue
                rows.append(l)
                ds.append(int(np.ceil(dval)))
            return rows, ds

        result = np.zeros(k, dtype=np.int64)
        ips = 0
        x_prev = req.x_hint
        for j in req.perm:
            rows, ds = cover_d()
            try:
                opt, x = solver.solve(
                    j, rows, ds, x_hint=x_prev, pool=self._pool
                )
            except NodeLimitExceeded:
                return self._general_fallback().lex_solve(req)
            ips += 1
            self.ip_count += 1
            if opt is None:
                return LexOutcome(SolveStatus.INFEASIBLE, None, ips)
            x_prev = x
            self._pool_add(x)
            val = -opt if fam.mirror else opt
            result[j] = int(val)
            srhs[j] = float(val)
        return LexOutcome(SolveStatus.OPTIMAL, result, ips, x=x_prev)

    def lex_solve_batch(self, reqs: List[LexRequest]) -> List[LexOutcome]:
        return [self.lex_solve(r) for r in reqs]

"""Exact combinatorial engine for the (multi-objective) assignment family.

The reference solves its AP family (Timing.ods 2AP sheet: 2AP40..2AP500)
through CPLEX, whose network-simplex extraction carries the hardness
(src/aira.cpp:480-487).  The rebuilt LP branch-and-bound pays ~10-30 ms of
massively degenerate simplex per node on the Birkhoff polytope and drowns:
measured 2AP40 = 551 s vs the reference's 10.95 s TOTAL, with 55% of the
wall inside the exact f64 lockstep LP.  The matching
court (solver/match_court.py) closes many of those nodes, but the engine
underneath still thinks in LPs.

This module replaces the LP entirely for the family, the same move that
made KP2D tractable (solver/kp_bb.py).  Each lex-stage IP is

    minimise  V[j].x   over perfect matchings x of an N x N bipartite
              structure, subject to side rows  V[l].x <= u_l
              (objective-bound rows of the epsilon ladder)

and is solved by Lagrangian matching branch-and-bound:

* the relaxation keeping only the matching rows is the Birkhoff polytope:
  min-cost perfect matching answers ANY linear question over it exactly
  (total unimodularity; integer costs, so the optimal value is an exact
  integer);
* one violated side row folds into the cost by the classical
  Handler-Zang bisection: multipliers are RATIONALS p/q with the blend
  computed as the INTEGER matrix q*V[j] + p*V[l], so every matching value
  M is an exact integer and
      min V[j].x  >=  ceil( (M - p*u) / q )
  is a rigorous integer bound — no float ever feeds a decision;
* a feasible blend-attaining matching whose V[j] value equals the bound
  closes the node exactly (complementary slackness made integral);
* stages whose previous objectives are binding close in ONE matching: the
  lexicographic blend Q*V[prev] + V[j] with Q > range(V[j]) returns the
  exact constrained optimum directly;
* remaining gaps branch on a cell of the violating matching
  (forbid / force), DFS with the bound re-derived per node.

Everything that feeds a prune / accept / close decision is exact int64
arithmetic; magnitudes are guarded so f64 matching sums stay below 2^53
(scipy's Hungarian sums costs in doubles).  The exactness invariant holds
with no LP and no f64 certification because there is nothing inexact to
certify.

Where it plugs in: ``APLexBackend`` is a drop-in lex backend
(api.make_backend routes the detected family to it under ``auto``);
``detect_ap_family`` is deliberately conservative — binary variables, ALL
structural rows forming one square bipartite equality structure, integer
objectives — everything else keeps the general engine.
"""

from __future__ import annotations

import dataclasses
from math import gcd
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from moip_aira_tpu_torch.problem import Problem
from moip_aira_tpu_torch.sense import INF, Sense
from moip_aira_tpu_torch.solver.lex import LexOutcome, LexRequest
from moip_aira_tpu_torch.solver.status import SolveStatus

#: forbidden-cell sentinel (int): large enough to dominate any real blend,
#: small enough that N * BIG stays exactly representable in f64 (scipy's
#: Hungarian accumulates costs in doubles): 1000 * 2^40 = 2^50 < 2^53
BIG = 1 << 40

#: hard node ceiling per IP — a blown ceiling raises and the caller falls
#: back to the general engine; nothing is silently truncated
NODE_LIMIT = 2_000_000

#: incumbent-pool width kept by the backend across lex IPs
POOL_CAP = 256

#: Handler-Zang bisection step ceiling per node (defensive; the bisection
#: terminates on its own — each step visits a new matching vertex)
BISECT_CAP = 64

from scipy.optimize import linear_sum_assignment as _lsa  # noqa: E402


class NodeLimitExceeded(RuntimeError):
    pass


class BlendMagnitudeError(ValueError):
    """An integer blend whose matching sums f64 cannot carry exactly."""


def blend_bound(N: int, vmax: int) -> int:
    """Largest |entry| of any blend this engine builds for side size ``N``
    and objective magnitude ``vmax``: the lexicographic blend Q*g + f with
    Q = 2*N*vmax + 1 reaches 2*N*vmax^2 + 2*vmax, and a Handler-Zang blend
    q*f + p*g with p, q <= 2*N*vmax (differences of matching values)
    reaches 4*N*vmax^2."""
    return 4 * N * vmax * vmax + 2 * vmax


def blend_safe(bmax: int, N: int) -> bool:
    """True when N cells of magnitude ``bmax`` sum exactly in _match_min
    (the bound the forbidden-cell sentinel BIG leaves room for)."""
    return (bmax + 1) * N < BIG // 4


def _ceil_div(a: int, b: int) -> int:
    """Exact ceil(a / b) for ints, b > 0."""
    return -((-a) // b)


@dataclasses.dataclass
class APFamily:
    """Canonical MIN-form assignment family (all integer data).

    ``mirror`` is True when the original problem maximises: objective
    values negate on the way out and bound rhs negate on the way in.
    """

    N: int  # side size (square)
    colA: np.ndarray  # (n,) side-A index per column
    colB: np.ndarray  # (n,) side-B index per column
    pair2col: np.ndarray  # (N, N) column id or -1
    V: np.ndarray  # (objcnt, n) int64 MIN-form objective rows
    mirror: bool


def detect_ap_family(problem: Problem) -> Optional[APFamily]:
    """Canonicalise ``problem`` to the assignment family, or return None.

    Accepts: all variables binary; ALL structural rows are 0/1 equality
    rows with rhs 1 forming one square bipartite 2-regular structure (the
    shape of the upstream Examples/2AP05.lp); objectives integer.  Any
    extra structural row, non-square sides, or duplicate cells reject —
    those shapes keep the general engine.
    """
    p = problem
    if p.objcnt < 2 or p.n == 0 or p.m_struct < 2:
        return None
    if not bool(np.all(p.is_int)):
        return None
    if not (np.all(p.lb == 0) and np.all(p.ub == 1)):
        return None
    C = np.asarray(p.C, dtype=np.float64)
    if not np.all(np.isfinite(C)) or not np.all(C == np.rint(C)):
        return None
    from moip_aira_tpu_torch.solver.heuristics import detect_assignment

    lo = np.concatenate([p.lb, p.row_lb])
    hi = np.concatenate([p.ub, p.row_ub])
    struct = detect_assignment(np.asarray(p.A, dtype=np.float64), lo, hi)
    if struct is None:
        return None
    if struct.ineq_rows.size:
        return None  # extra structural rows: not the pure family
    NA, NB = struct.sideA.size, struct.sideB.size
    if NA != NB:
        return None  # no perfect matching structure
    if np.count_nonzero(struct.pair2col >= 0) != p.n:
        return None  # duplicate (a, b) cells collapsed: reject
    V = np.rint(C).astype(np.int64)
    if p.objsen is Sense.MAX:
        V = -V
    # magnitude guard, the same bound _match_min enforces on every blend:
    # an instance whose largest blend (blend_bound) would not sum exactly
    # keeps the general engine
    vmax = int(np.abs(V).max(initial=0))
    if not blend_safe(blend_bound(NA, vmax), NA):
        return None
    return APFamily(
        N=NA,
        colA=struct.colA.copy(),
        colB=struct.colB.copy(),
        pair2col=struct.pair2col.copy(),
        V=V,
        mirror=p.objsen is Sense.MAX,
    )


class APIPSolver:
    """Exact branch-and-bound for ONE canonical assignment IP.

    minimise V[j].x  s.t.  V[l].x <= u_l (l in cov_rows),  x a perfect
    matching honouring the node's forced / forbidden cells.
    """

    def __init__(self, fam: APFamily):
        self.fam = fam
        self.nodes = 0
        self.matchings = 0
        #: reused (N, N) cost buffer — profiling showed matrix construction
        #: (np.full + fancy writes) cost ~12x the Hungarian itself at N=5
        self._M = np.empty((fam.N, fam.N), dtype=np.float64)
        self._rows_idx = np.arange(fam.N)
        #: tiny sides enumerate all N! permutations in one vectorised
        #: argmin instead of scipy's Hungarian — exact by definition, and
        #: ~3 numpy calls beat ~8 + the LSAP solver (4AP05 is 35k matchings
        #: of N=5; 6! x 6 = 4,320 cells is still trivially small)
        self._perms = None
        if fam.N <= 6:
            from itertools import permutations

            self._perms = np.array(
                list(permutations(range(fam.N))), dtype=np.int64
            )

    # -- core exact primitives ----------------------------------------------
    def _is_matching(self, x: np.ndarray, cols: np.ndarray) -> bool:
        """True when 0/1 vector ``x`` (its ones at ``cols``) is a perfect
        matching: N cells, one in every side-A and every side-B line."""
        fam = self.fam
        return (
            x.shape == (fam.V.shape[1],)
            and bool(np.all((x == 0.0) | (x == 1.0)))
            and cols.size == fam.N
            and np.unique(fam.colA[cols]).size == fam.N
            and np.unique(fam.colB[cols]).size == fam.N
        )

    def _node_ctx(self, forbid: np.ndarray, forced: Sequence[int]):
        """Per-node allowed-cell index array, or None on a forced clash.

        Folds the node's forbids AND the line-blocking of its forced cells
        into one index array once per node — _match_min runs 3-8 times per
        node with different blends but the SAME restrictions (profiled:
        redoing this per matching was half of _match_min's cost).
        """
        fam = self.fam
        ok = ~forbid
        if forced:
            fj = np.asarray(forced, dtype=np.int64)
            ra, cb = fam.colA[fj], fam.colB[fj]
            if (
                len(set(ra.tolist())) != fj.size
                or len(set(cb.tolist())) != fj.size
            ):
                return None  # two forced cells share a line: node empty
            if np.any(forbid[fj]):
                return None  # a forced cell is forbidden: node empty
            rowb = np.zeros(fam.N, dtype=bool)
            rowb[ra] = True
            colb = np.zeros(fam.N, dtype=bool)
            colb[cb] = True
            ok &= ~(rowb[fam.colA] | colb[fam.colB])
            ok[fj] = True
        return np.flatnonzero(ok)

    def _match_min(
        self, blend: np.ndarray, allowed: np.ndarray
    ) -> Tuple[Optional[int], Optional[np.ndarray]]:
        """Exact min of integer ``blend``.x over the node's matchings.

        ``allowed`` is the node's cell-index array from _node_ctx.
        Returns (value, cols) with cols the selected column ids, or
        (None, None) when no perfect matching honours the node — an exact
        infeasibility proof.  ``blend`` must be int64; a blend too large
        for exact f64 sums inside scipy's Hungarian raises
        BlendMagnitudeError (detect_ap_family keeps such instances out).
        """
        fam = self.fam
        N = fam.N
        bmax = int(np.abs(blend).max(initial=0))
        if not blend_safe(bmax, N):
            raise BlendMagnitudeError(
                f"ap_bb: blend magnitude {bmax} unsafe for N={N}"
            )
        M = self._M
        M.fill(float(BIG))
        M[fam.colA[allowed], fam.colB[allowed]] = blend[allowed]
        self.matchings += 1
        if self._perms is not None:
            vals = M[self._rows_idx, self._perms].sum(axis=1)
            k = int(np.argmin(vals))
            if vals[k] >= BIG / 2:
                return None, None  # every permutation hits a forbidden cell
            ci = self._perms[k]
            cols = fam.pair2col[self._rows_idx, ci]
            return int(blend[cols].sum()), cols
        ri, ci = _lsa(M)
        total = M[ri, ci]
        if np.any(total >= BIG / 2):
            return None, None  # some row had only forbidden cells
        cols = fam.pair2col[ri, ci]
        # integer re-sum: f64 was exact by the magnitude guard, but the
        # decision value is recomputed in int64 as defence in depth
        return int(blend[cols].sum()), cols

    # -- the exact solve ----------------------------------------------------
    def solve(
        self,
        j: int,
        cov_rows: Sequence[int],
        cov_u: Sequence[int],
        x_hint: Optional[np.ndarray] = None,
        pool: Optional[np.ndarray] = None,
    ):
        """Minimise objective ``j`` under V[cov_rows].x <= cov_u.

        ``pool`` is a (p, n) 0/1 matrix of matchings from past IPs;
        box-feasible members seed the incumbent.  Returns (opt, x 0/1
        ndarray) or (None, None) if infeasible.
        """
        fam = self.fam
        n = fam.V.shape[1]
        f = fam.V[j]
        rows = [int(r) for r in cov_rows]
        us = [int(u) for u in cov_u]
        # vectorised side-row machinery shared with _judge_node (profiling:
        # per-row python sums were ~20% of the whole 4AP05 solve)
        self._Vrows = fam.V[rows] if rows else np.zeros((0, n), np.int64)
        self._us = np.asarray(us, dtype=np.int64)

        best_v: Optional[int] = None
        best_cols: Optional[np.ndarray] = None

        def consider_cols(cols: np.ndarray) -> bool:
            """Incumbent update from a matching known feasible for the
            side rows; returns True if it improved."""
            nonlocal best_v, best_cols
            val = int(f[cols].sum())
            if best_v is None or val < best_v:
                best_v = val
                best_cols = cols.copy()
                return True
            return False

        Vr, us_a = self._Vrows, self._us

        def side_ok(cols: np.ndarray) -> bool:
            return bool(np.all(Vr[:, cols].sum(axis=1) <= us_a))

        # tiny sides: the WHOLE IP solves exactly by feasibility-filtered
        # enumeration of all N! matchings — one vectorised pass, no
        # branch-and-bound (4AP05's k=4 boxes cost ~16 B&B nodes/IP on
        # single-row bounds; this replaces them with ~5 numpy ops)
        if self._perms is not None:
            cm = fam.pair2col[self._rows_idx, self._perms]  # (N!, N)
            okp = np.all(cm >= 0, axis=1)  # perms using only real cells
            if not okp.all():
                cm = cm[okp]
            if cm.shape[0] == 0:
                return None, None
            vals = f[cm].sum(axis=1)  # (P,) int64, exact
            if rows:
                feas = np.all(
                    Vr[:, cm].sum(axis=2) <= us_a[:, None], axis=0
                )
            else:
                feas = np.ones(cm.shape[0], dtype=bool)
            if not feas.any():
                return None, None
            k = int(np.argmin(np.where(feas, vals, np.iinfo(np.int64).max)))
            best_cols = cm[k]
            best_v = int(vals[k])
            x = np.zeros(n, dtype=np.float64)
            x[best_cols] = 1.0
            for r, u in zip(rows, us):
                assert int(fam.V[r][best_cols].sum()) <= u
            assert int(f[best_cols].sum()) == best_v
            return best_v, x

        # ---- incumbent seeding (pool + hint: advisory only) --------------
        if pool is not None and pool.shape[0]:
            sel = pool.astype(bool)
            ok = np.ones(pool.shape[0], dtype=bool)
            for r, u in zip(rows, us):
                ok &= pool @ fam.V[r] <= u
            if ok.any():
                vals = pool[ok] @ f
                kbest = int(np.argmin(vals))
                cols = np.flatnonzero(sel[np.flatnonzero(ok)[kbest]])
                if cols.size == fam.N:
                    consider_cols(cols)
        if x_hint is not None:
            xh = np.rint(np.asarray(x_hint, dtype=np.float64))
            cols = np.flatnonzero(xh > 0.5)
            if self._is_matching(xh, cols) and side_ok(cols):
                consider_cols(cols)

        # iterative DFS over (forbid, forced) states — an op stack with
        # apply/undo entries instead of recursion, so a long forbid chain
        # (depth can reach O(n) before bounds bite) can never hit Python's
        # recursion ceiling on the big ladder sizes (2AP200+)
        forbid = np.zeros(n, dtype=bool)
        forced: List[int] = []
        root = True
        stack: List[Tuple[str, int]] = [("visit", -1)]
        while stack:
            op, e = stack.pop()
            if op == "visit":
                verdict = self._judge_node(
                    j, rows, us, forbid, forced, consider_cols, side_ok,
                    lambda: best_v,
                )
                if root and verdict == "infeasible_root":
                    return None, None
                root = False
                if isinstance(verdict, int):
                    # branch cell: forbid-first (toward side-feasibility),
                    # then force; ops pushed in reverse execution order
                    stack.append(("pop_force", verdict))
                    stack.append(("push_force", verdict))
                    stack.append(("pop_forbid", verdict))
                    stack.append(("push_forbid", verdict))
            elif op == "push_forbid":
                forbid[e] = True
                stack.append(("visit", -1))
            elif op == "pop_forbid":
                forbid[e] = False
            elif op == "push_force":
                forced.append(e)
                stack.append(("visit", -1))
            else:  # pop_force
                forced.pop()
        if best_cols is None:
            return None, None
        x = np.zeros(n, dtype=np.float64)
        x[best_cols] = 1.0
        # exact acceptance audit (defence in depth; a failure is a bug)
        assert best_cols.size == fam.N
        for r, u in zip(rows, us):
            assert int(fam.V[r][best_cols].sum()) <= u, "ap_bb: side violation"
        assert int(f[best_cols].sum()) == best_v, "ap_bb: objective mismatch"
        return best_v, x

    # -- one node: dual bound, closures, branch decision ---------------------
    def _judge_node(self, j, rows, us, forbid, forced, consider_cols,
                    side_ok, get_best):
        """Judge one DFS node; incumbents flow through ``consider_cols``/
        ``get_best`` closures (global across the whole IP: node matchings
        honour node restrictions, so any side-feasible one is IP-feasible).

        Returns "infeasible_root" (no matching at all — meaningful only
        when the caller is at the root), None (node closed: infeasible,
        pruned, or solved exactly), or an int branch cell for the caller's
        DFS driver to forbid/force."""
        fam = self.fam
        self.nodes += 1
        if self.nodes > NODE_LIMIT:
            raise NodeLimitExceeded(f"ap_bb node limit ({NODE_LIMIT})")
        f = fam.V[j]
        allowed = self._node_ctx(forbid, forced)
        if allowed is None:
            return None  # forced clash (never at the root: no forced there)
        v0, cols0 = self._match_min(f, allowed)
        if v0 is None:
            return "infeasible_root" if not forced and not forbid.any() else None
        if side_ok(cols0):
            # unconstrained node min is side-feasible: node closed exactly
            consider_cols(cols0)
            return None
        best = get_best()
        if best is not None and v0 >= best:
            return None  # even the unconstrained min can't improve
        # most-violated side row at the unconstrained matching (vectorised:
        # side_ok above already failed, so a positive violation exists)
        excess = self._Vrows[:, cols0].sum(axis=1) - self._us
        k_star = int(np.argmax(excess))
        r_star, u_star = rows[k_star], us[k_star]
        g = fam.V[r_star]

        # single-row infeasibility: lexicographic blend Q*g + f minimises g
        # first, tie-breaking by f.  Q must exceed the spread of f.x over
        # matchings, which with mixed signs is up to 2*N*max|f|
        Q = 2 * fam.N * int(np.abs(f).max(initial=0)) + 1
        vg, colsg = self._match_min(Q * g + f, allowed)
        if vg is None:
            return None  # matchings vanished under the node (forced clash)
        gmin = int(g[colsg].sum())
        if gmin > u_star:
            return None  # exact: no matching can satisfy row r_star
        if side_ok(colsg):
            consider_cols(colsg)
        best = get_best()

        # Handler-Zang on row r_star: endpoints (violating x_lo, feasible-
        # for-r_star x_hi); all arithmetic exact-rational via int blends
        F_lo, G_lo = v0, int(g[cols0].sum())
        F_hi, G_hi = int(f[colsg].sum()), gmin
        bound = v0  # lam=0 dual value; improves monotonically below
        x_lo = cols0
        for _ in range(BISECT_CAP):
            dG = G_lo - G_hi
            dF = F_hi - F_lo
            if dG <= 0 or dF <= 0:
                # degenerate geometry: the lam=0 bound (or the last fold)
                # is already the best this pair offers
                break
            d = gcd(dF, dG)
            p, q = dF // d, dG // d
            Mv, colsm = self._match_min(q * f + p * g, allowed)
            if Mv is None:
                return None
            cross = q * F_lo + p * G_lo  # == q*F_hi + p*G_hi by construction
            node_lb = _ceil_div(Mv - p * u_star, q)
            if node_lb > bound:
                bound = node_lb
            Gm = int(g[colsm].sum())
            if Gm <= u_star and side_ok(colsm):
                consider_cols(colsm)
                best = get_best()
            if Mv >= cross:
                # no matching below the endpoint line: dual optimum reached
                break
            if Gm > u_star:
                F_lo, G_lo, x_lo = int(f[colsm].sum()), Gm, colsm
            else:
                F_hi, G_hi = int(f[colsm].sum()), Gm
            if best is not None and bound >= best:
                return None
        best = get_best()
        if best is not None and bound >= best:
            return None  # rigorous prune
        if best is not None and best == bound:
            return None  # incumbent provably optimal for this node
        # branch on the violating matching's heaviest cell in row r_star
        cand = [c for c in x_lo.tolist() if not forbid[c] and c not in forced]
        if not cand:
            return None  # fully pinned matching already judged above
        return max(cand, key=lambda c: int(g[c]))


class APLexBackend:
    """Lex backend: every stage IP solved by the matching engine.

    Mirrors NumpyLexBackend.lex_solve's stage loop (solver/lex.py:75-110,
    itself reference aira.cpp:452-536): optimise the permutation's
    objectives in order, fixing each bound to the achieved optimum.
    """

    name = "apbb"

    def __init__(self, problem: Problem, fam: Optional[APFamily] = None):
        self.problem = problem
        self.fam = fam if fam is not None else detect_ap_family(problem)
        if self.fam is None:
            raise ValueError(
                f"{problem.filename}: not in the assignment family"
            )
        self.ip_count = 0
        self.node_count = 0
        self.matching_count = 0
        self._fallback = None
        #: rolling pool of optimal matchings from past IPs: strong warm
        #: incumbents for neighbouring boxes in the epsilon ladder
        self._pool = np.zeros((0, problem.n), dtype=np.int64)

    def _general_fallback(self):
        if self._fallback is None:
            from moip_aira_tpu_torch.solver.lex import NumpyLexBackend

            self._fallback = NumpyLexBackend(self.problem)
        return self._fallback

    def _pool_add(self, x: np.ndarray):
        xi = np.rint(x).astype(np.int64)
        if self._pool.shape[0] and np.any(np.all(self._pool == xi, axis=1)):
            return
        self._pool = np.vstack([self._pool, xi[None]])
        if self._pool.shape[0] > POOL_CAP:
            self._pool = self._pool[-POOL_CAP:]

    def lex_solve(self, req: LexRequest) -> LexOutcome:
        p = self.problem
        fam = self.fam
        k = p.objcnt
        solver = APIPSolver(fam)
        srhs = np.asarray(req.rhs, dtype=np.float64).copy()

        def bounds() -> Tuple[List[int], List[int]]:
            rows: List[int] = []
            us: List[int] = []
            for l in range(k):
                r = srhs[l]
                uval = -r if fam.mirror else r  # MIN-form: V[l].x <= uval
                if uval == INF or not np.isfinite(uval):
                    continue
                rows.append(l)
                us.append(int(np.floor(uval)))
            return rows, us

        result = np.zeros(k, dtype=np.int64)
        ips = 0
        x_prev = req.x_hint
        for j in req.perm:
            rows, us = bounds()
            try:
                opt, x = solver.solve(
                    j, rows, us, x_hint=x_prev, pool=self._pool
                )
            except NodeLimitExceeded:
                self.node_count += solver.nodes
                self.matching_count += solver.matchings
                return self._general_fallback().lex_solve(req)
            ips += 1
            self.ip_count += 1
            if opt is None:
                self.node_count += solver.nodes
                self.matching_count += solver.matchings
                return LexOutcome(SolveStatus.INFEASIBLE, None, ips)
            x_prev = x
            self._pool_add(x)
            val = -opt if fam.mirror else opt
            result[j] = int(val)
            srhs[j] = float(val)
        self.node_count += solver.nodes
        self.matching_count += solver.matchings
        return LexOutcome(SolveStatus.OPTIMAL, result, ips, x=x_prev)

    def lex_solve_batch(self, reqs: List[LexRequest]) -> List[LexOutcome]:
        return [self.lex_solve(r) for r in reqs]

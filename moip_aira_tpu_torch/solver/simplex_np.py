"""Dense bounded-variable full-tableau simplex — NumPy reference backend.

This is the host-side reference implementation of the LP kernel that replaces
the LP relaxation inside CPLEX's ``CPXmipopt`` (reference src/aira.cpp:480).
The JAX/TPU backend (solver/simplex_jax.py) implements the *same algorithm*
with the same tolerances so both produce identical bases; this NumPy version
is the debuggable oracle used by the unit tests — and the EXACT court of last
resort for every device lane whose f64 certificate fails, so its terminal
claims must be trustworthy under arbitrary (including adversarial) warm
bases.

Formulation ("logical variable" form, as used by production LP codes):

    variables  z = (x, r),  x structural (n), r row activities (m)
    constraint [A | -I] z = 0
    bounds     lb <= x <= ub,  row_lb <= r <= row_ub

The initial basis is the logical identity (B = -I), which is always
nonsingular; structural variables start nonbasic at a finite bound.  A
composite phase-1 (minimise total bound infeasibility of basic variables,
cf. Maros, "Computational Techniques of the Simplex Method") reaches
feasibility without artificial variables or big-M, then phase-2 optimises
``c @ x``.  Degenerate cycling is broken by switching to Bland's rule after a
stall.  All data in the target problems is integer, so float64 arithmetic
with 1e-7 tolerances recovers exact optima — PROVIDED the tableau has not
drifted.  Two defences make that proviso real (both motivated by a measured
failure: a garbage f32 device basis warm-started ~7k pivots of rank-1
updates, the tableau rotted, and phase-1 declared a feasible LP INFEASIBLE,
which surfaced as a dominated point on 2AP40):

* periodic refactorisation — every ``REFACTOR_EVERY`` basis changes the
  tableau and basic values are recomputed from scratch (``T = B^-1 W``,
  ``xB = -T_N z_N``), discarding accumulated rank-1-update error;
* refactor-verified termination — INFEASIBLE / OPTIMAL / UNBOUNDED are only
  returned when the deciding state was computed from a freshly refactored
  tableau; a stale-tableau "conclusion" triggers a refactor and the loop
  continues from exact data instead.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from moip_aira_tpu_torch.sense import INF
from moip_aira_tpu_torch.solver.status import SolveStatus

FEAS_TOL = 1e-7
COST_TOL = 1e-9
PIVOT_TOL = 1e-9
STALL_LIMIT = 60  # iterations without objective progress before Bland's rule
REFACTOR_EVERY = 256  # basis changes between tableau recomputations
# A warm basis is used only when its inverse can be trusted: np.linalg.solve
# neither raises nor returns non-finite values on a numerically singular
# basis (cond(B) ~ 6e17 from an f32 device basis was measured on 2AP20),
# and the garbage tableau it returns ends in a false INFEASIBLE.
WARM_COND_MAX = 1e12  # largest 1-norm condition number of a warm basis
WARM_RESID_TOL = 1e-9  # largest |B B^-1 - I| entry of a warm basis


class LPResult(NamedTuple):
    status: SolveStatus
    obj: float
    x: Optional[np.ndarray]  # structural variable values (n,)
    #: reduced costs of all columns at the final basis (None unless optimal);
    #: used for reduced-cost variable fixing in branch-and-bound
    d: Optional[np.ndarray] = None
    #: True for nonbasic-at-upper columns (with d, defines the fixing side)
    at_upper: Optional[np.ndarray] = None
    in_basis: Optional[np.ndarray] = None


class SimplexWorkspace:
    """Per-problem static data: W = [A_full | -I] with A_full = [A; C]."""

    def __init__(self, A_full: np.ndarray):
        self.m, self.n = A_full.shape
        self.W = np.hstack([A_full, -np.eye(self.m)])
        self.ncols = self.n + self.m


def _norm1(M):
    """Matrix 1-norm over the last two axes (max column abs sum)."""
    return np.abs(M).sum(axis=-2).max(axis=-1)


def inverse_ok(B, B_inv):
    """True where ``B_inv`` is a trustworthy inverse of ``B`` (both (..., m,
    m)): finite, 1-norm condition number ||B|| ||B^-1|| at most
    WARM_COND_MAX, and residual max|B B^-1 - I| at most WARM_RESID_TOL."""
    m = B.shape[-1]
    with np.errstate(all="ignore"):
        cond = _norm1(B) * _norm1(B_inv)
        resid = np.abs(B @ B_inv - np.eye(m)).max(axis=(-2, -1))
    return np.isfinite(cond) & (cond <= WARM_COND_MAX) & (resid <= WARM_RESID_TOL)


def _refactor(ws, basis, in_basis, zvals, strict=False):
    """Exact state from scratch: T = B^-1 W, xB = -T_N z_N.

    Returns (T, xB) or (None, None) if the basis matrix is singular, or
    with ``strict`` (a warm basis from elsewhere) if it is ill-conditioned
    (``inverse_ok``; B^-1 is T's logical block negated, as W's is -I).
    """
    B = ws.W[:, basis]
    try:
        T = np.linalg.solve(B, ws.W)
    except np.linalg.LinAlgError:
        return None, None
    if not np.isfinite(T).all():
        return None, None
    if strict and not inverse_ok(B, -T[:, ws.n :]):
        return None, None
    nb = ~in_basis
    xB = -T[:, nb] @ zvals[nb]
    return T, xB


def solve_lp(
    ws: SimplexWorkspace,
    c: np.ndarray,
    lo: np.ndarray,
    hi: np.ndarray,
    max_iters: int = 20000,
    warm_basis: Optional[np.ndarray] = None,
    warm_at_upper: Optional[np.ndarray] = None,
) -> LPResult:
    """Minimise c @ x subject to [A|-I] z = 0, lo <= z <= hi.

    ``lo``/``hi`` have length n + m: structural bounds then row-activity
    bounds (objective-bound rows included in A_full by the caller).

    ``warm_basis``/``warm_at_upper`` restart from an advanced basis (e.g. the
    basis an f32 device kernel returned).  The warm basis is validated
    (in-range, duplicate-free, well-conditioned (``inverse_ok``),
    bound-consistent statuses) and then has to BEAT the cold logical basis
    on initial infeasibility to be used — a near-optimal basis wins by
    miles, a garbage one loses and the solve silently starts cold.  An
    INFEASIBLE or ITERATION_LIMIT reached from a warm start is confirmed by
    a cold solve, whose answer is returned.  Correctness never depends on
    the choice.
    """
    res, started_warm = _solve_lp(
        ws, c, lo, hi, max_iters, warm_basis, warm_at_upper
    )
    if started_warm and res.status in (
        SolveStatus.INFEASIBLE, SolveStatus.ITERATION_LIMIT
    ):
        res, _ = _solve_lp(ws, c, lo, hi, max_iters, None, None)
    return res


def _solve_lp(ws, c, lo, hi, max_iters, warm_basis, warm_at_upper):
    """solve_lp's simplex; returns (LPResult, whether it started warm)."""
    m, ncols = ws.m, ws.ncols
    n = ws.n
    cz = np.zeros(ncols)
    cz[:n] = c

    # quick bound sanity: an empty box is infeasible
    if np.any(lo > hi + FEAS_TOL):
        return LPResult(SolveStatus.INFEASIBLE, np.nan, None), False

    finite_lo = np.isfinite(lo)
    finite_hi = np.isfinite(hi)

    def _start_state(basis, at_upper, strict=False):
        in_basis = np.zeros(ncols, dtype=bool)
        in_basis[basis] = True
        # nonbasic statuses must name a finite bound; repair any that don't
        at_upper = at_upper & finite_hi
        at_upper = at_upper | (~finite_lo & finite_hi)
        zvals = np.where(at_upper, hi, np.where(finite_lo, lo, 0.0))
        zvals[~finite_lo & ~finite_hi] = 0.0  # free vars at 0
        T, xB = _refactor(ws, basis, in_basis, zvals, strict)
        if T is None:
            return None
        infeas = float(
            np.sum(np.maximum(lo[basis] - xB, 0.0))
            + np.sum(np.maximum(xB - hi[basis], 0.0))
        )
        return basis, at_upper, in_basis, zvals, T, xB, infeas

    # --- cold start: logical basis (B = -I, always nonsingular) ------------
    cold_basis = np.arange(n, n + m)
    cold_up = np.zeros(ncols, dtype=bool)
    cold_up[:n] = ~finite_lo[:n] & finite_hi[:n]
    state = _start_state(cold_basis, cold_up)
    started_warm = False

    if warm_basis is not None and warm_at_upper is not None:
        wb = np.asarray(warm_basis, dtype=np.int64)
        if (
            wb.shape == (m,)
            and (wb >= 0).all()
            and (wb < ncols).all()
            and len(np.unique(wb)) == m
        ):
            warm = _start_state(
                wb.copy(), np.asarray(warm_at_upper, dtype=bool).copy(), True
            )
            if warm is not None and (state is None or warm[6] < state[6]):
                state = warm
                started_warm = True
    if state is None:  # cannot happen (cold B = -I); guard anyway
        return LPResult(SolveStatus.ITERATION_LIMIT, np.nan, None), False
    basis, at_upper, in_basis, zvals, T, xB, _ = state

    stall = 0
    last_obj = np.inf
    phase = 0  # recomputed from infeasibility at the top of every iteration
    since_refactor = 0  # basis changes since T/xB were computed exactly

    def _try_refactor():
        """Recompute T and xB exactly; True on success."""
        nonlocal T, xB, since_refactor
        T2, xB2 = _refactor(ws, basis, in_basis, zvals)
        if T2 is None:
            return False
        T, xB = T2, xB2
        since_refactor = 0
        return True

    for it in range(max_iters):
        if since_refactor >= REFACTOR_EVERY:
            _try_refactor()
        bl = lo[basis]
        bh = hi[basis]
        below = xB < bl - FEAS_TOL
        above = xB > bh + FEAS_TOL
        infeasible_sum = np.sum(np.where(below, bl - xB, 0.0)) + np.sum(
            np.where(above, xB - bh, 0.0)
        )
        new_phase = 1 if infeasible_sum > FEAS_TOL else 2
        if new_phase != phase:
            phase = new_phase
            stall = 0
            last_obj = np.inf

        if phase == 1:
            cB = np.where(below, -1.0, np.where(above, 1.0, 0.0))
            cur_obj = infeasible_sum
        else:
            cB = cz[basis]
            cur_obj = cz[basis] @ xB + cz[~in_basis] @ zvals[~in_basis]

        # reduced costs d_j = c_j - cB @ T[:, j]  (zero for basic columns)
        d = cz - cB @ T if phase == 2 else -(cB @ T)

        nb = ~in_basis
        free = nb & ~finite_lo & ~finite_hi
        can_up = nb & (((~at_upper) & (d < -COST_TOL)) | (free & (d < -COST_TOL)))
        can_dn = nb & ((at_upper & (d > COST_TOL)) | (free & (d > COST_TOL)))
        eligible = can_up | can_dn
        if not eligible.any():
            # terminal claim — only trust it from an exact (fresh) tableau;
            # rank-1-update drift has been measured to flip this verdict
            if since_refactor > 0 and _try_refactor():
                continue
            if phase == 1:
                return LPResult(SolveStatus.INFEASIBLE, np.nan, None), started_warm
            # optimal
            z = zvals.copy()
            z[basis] = xB
            d_full = cz - cz[basis] @ T
            return LPResult(
                SolveStatus.OPTIMAL,
                float(cz @ z),
                z[:n],
                d=d_full,
                at_upper=at_upper.copy(),
                in_basis=in_basis.copy(),
            ), started_warm

        if stall >= STALL_LIMIT:
            q = int(np.flatnonzero(eligible)[0])  # Bland
        else:
            scores = np.where(eligible, np.abs(d), -1.0)
            q = int(np.argmax(scores))
        sigma = 1.0 if can_up[q] else -1.0

        alpha = T[:, q]
        eta = -sigma * alpha  # d xB_i / d theta

        # --- ratio test ---------------------------------------------------
        theta = np.inf
        leave = -1  # -1 => bound flip of the entering variable
        leave_to_upper = False

        # entering variable's own opposite bound
        if finite_lo[q] and finite_hi[q]:
            theta = hi[q] - lo[q]

        moving = np.abs(eta) > PIVOT_TOL
        idx = np.flatnonzero(moving)
        if idx.size:
            e = eta[idx]
            xb = xB[idx]
            bl_i = bl[idx]
            bh_i = bh[idx]
            below_i = below[idx]
            above_i = above[idx]
            ratios = np.full(idx.size, np.inf)
            hits_upper = np.zeros(idx.size, dtype=bool)
            feas = ~below_i & ~above_i
            # feasible basics block at the bound they move towards
            mdn = feas & (e < 0) & np.isfinite(bl_i)
            ratios[mdn] = (xb[mdn] - bl_i[mdn]) / (-e[mdn])
            mup = feas & (e > 0) & np.isfinite(bh_i)
            ratios[mup] = (bh_i[mup] - xb[mup]) / e[mup]
            hits_upper[mup] = True
            # infeasible basics block when they *reach* the violated bound
            mbu = below_i & (e > 0)
            ratios[mbu] = (bl_i[mbu] - xb[mbu]) / e[mbu]
            mau = above_i & (e < 0)
            ratios[mau] = (xb[mau] - bh_i[mau]) / (-e[mau])
            hits_upper[mau] = True
            ratios = np.maximum(ratios, 0.0)
            rmin = ratios.min()
            if rmin < theta:
                # tie-break: largest |pivot| for stability (Bland: smallest idx)
                tied = np.flatnonzero(ratios <= rmin + FEAS_TOL)
                if stall >= STALL_LIMIT:
                    pick = tied[np.argmin(basis[idx[tied]])]
                else:
                    pick = tied[np.argmax(np.abs(e[tied]))]
                theta = ratios[pick]
                leave = int(idx[pick])
                leave_to_upper = bool(hits_upper[pick])

        if not np.isfinite(theta):
            # terminal claim (unbounded ray / no blocking row) — same rule:
            # only trust it computed from a fresh tableau
            if since_refactor > 0 and _try_refactor():
                continue
            if phase == 1:
                # cannot happen for a bounded phase-1; guard anyway
                return LPResult(SolveStatus.INFEASIBLE, np.nan, None), started_warm
            return LPResult(SolveStatus.UNBOUNDED, -np.inf, None), started_warm

        # --- apply step ---------------------------------------------------
        xB = xB + eta * theta
        if leave < 0:
            # bound flip
            at_upper[q] = ~at_upper[q]
            zvals[q] = hi[q] if at_upper[q] else lo[q]
        else:
            p = basis[leave]
            # leaving variable becomes nonbasic at the bound it hit
            at_upper[p] = leave_to_upper
            zvals[p] = hi[p] if leave_to_upper else lo[p]
            in_basis[p] = False
            in_basis[q] = True
            # entering variable's new value
            start = zvals[q] if (finite_lo[q] or finite_hi[q]) else 0.0
            newval = start + sigma * theta
            # pivot the tableau on (leave, q)
            piv = T[leave, q]
            T[leave, :] = T[leave, :] / piv
            col = T[:, q].copy()
            col[leave] = 0.0
            T -= np.outer(col, T[leave, :])
            basis[leave] = q
            xB[leave] = newval
            since_refactor += 1

        # stall detection (objective progress)
        if cur_obj < last_obj - 1e-12:
            stall = 0
        else:
            stall += 1
        last_obj = cur_obj

    return LPResult(SolveStatus.ITERATION_LIMIT, np.nan, None), started_warm

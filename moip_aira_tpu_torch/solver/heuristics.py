"""Primal heuristics for the branch-and-bound backends.

The LP-guided tree search proves optimality cheaply once a near-optimal
incumbent exists (integral data + ceiling bounds make the pruning window
narrow); what the plain dive lacks is incumbent *quality*.  This module
supplies it generically:

* ``round_candidates`` — the rounded/floored LP point (clipped to node
  bounds), feasibility-checked;
* ``local_search``   — vectorised 1-move / 1-swap improvement: all
  ``x_j += 1``, ``x_j -= 1`` and ``x_j += 1, x_l -= 1`` moves are evaluated
  in one broadcast feasibility check per round, taking the best improving
  feasible move until a local optimum.  On knapsack-family instances this
  routinely lands within a few units of the true optimum, collapsing the
  tree from thousands of nodes to tens.

Everything operates on the same (lo, hi) z-bound representation as the
simplex (structural bounds then row-activity bounds), so equality rows and
objective-bound rows are respected automatically.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

TOL = 1e-7


def candidate_value(
    Wx: np.ndarray,  # (m, n) structural part of [A|-I] (i.e. A_full)
    c: np.ndarray,
    lo: np.ndarray,
    hi: np.ndarray,
    x: np.ndarray,
) -> Optional[float]:
    """c @ x if x is feasible for bounds and row activities, else None."""
    n = Wx.shape[1]
    if np.any(x < lo[:n] - TOL) or np.any(x > hi[:n] + TOL):
        return None
    act = Wx @ x
    if np.any(act < lo[n:] - TOL) or np.any(act > hi[n:] + TOL):
        return None
    return float(c @ x)


#: above this many integer variables the full (m, ni, ni) swap tensor is
#: replaced by a candidate subset — keeps the heuristic O(m·K²) at scale
SWAP_FULL_LIMIT = 300
SWAP_CAND = 128


def repair(
    Wx: np.ndarray,
    c: np.ndarray,
    lo: np.ndarray,
    hi: np.ndarray,
    x0: np.ndarray,
    int_idx: np.ndarray,
    max_moves: int = 60,
) -> Optional[np.ndarray]:
    """Restore ROW feasibility of an integer point by unit moves/swaps.

    The bound-sweep chains (solver/sweep.py) hand each successor MIP the
    PARENT rung's optimal point as a warm hint: it satisfies every structural
    constraint but violates the new objective-bound row by exactly one front
    step, so one or two greedy swaps usually repair it into a near-optimal
    incumbent — where the rounding heuristic from a cold LP can be far off.

    Each move is chosen to minimise the total row violation, tie-broken by
    objective delta; a move must strictly reduce violation, so the loop
    terminates.  Returns a feasible x, or None if repair stalls.
    """
    n = Wx.shape[1]
    x = np.asarray(x0, dtype=np.float64).copy()
    if int_idx.size:
        x[int_idx] = np.rint(x[int_idx])
    x = np.clip(x, lo[:n], hi[:n])
    act = Wx @ x
    row_lo, row_hi = lo[n:], hi[n:]

    def violation(a):
        return np.maximum(row_lo - a, 0.0).sum() + np.maximum(
            a - row_hi, 0.0
        ).sum()

    viol = violation(act)
    if int_idx.size == 0:
        return x if viol <= TOL else None
    Wi = Wx[:, int_idx]
    ci = c[int_idx]
    lo_x, hi_x = lo[int_idx], hi[int_idx]
    ni = int_idx.size

    for _ in range(max_moves):
        if viol <= TOL:
            return x
        can_up = x[int_idx] + 1 <= hi_x + TOL
        can_dn = x[int_idx] - 1 >= lo_x - TOL
        act_up = act[:, None] + Wi  # (m, ni)
        act_dn = act[:, None] - Wi
        v_up = (
            np.maximum(row_lo[:, None] - act_up, 0.0)
            + np.maximum(act_up - row_hi[:, None], 0.0)
        ).sum(axis=0)
        v_dn = (
            np.maximum(row_lo[:, None] - act_dn, 0.0)
            + np.maximum(act_dn - row_hi[:, None], 0.0)
        ).sum(axis=0)
        v_up = np.where(can_up, v_up, np.inf)
        v_dn = np.where(can_dn, v_dn, np.inf)
        if ni <= SWAP_FULL_LIMIT:
            js = ls = np.arange(ni)
        else:
            ju = np.flatnonzero(can_up)
            ld = np.flatnonzero(can_dn)
            js = ju[np.argsort(ci[ju])[:SWAP_CAND]] if ju.size else ju
            ls = ld[np.argsort(-ci[ld])[:SWAP_CAND]] if ld.size else ld
        if js.size and ls.size:
            act_sw = act_up[:, js, None] - Wi[:, None, ls]
            v_sw = (
                np.maximum(row_lo[:, None, None] - act_sw, 0.0)
                + np.maximum(act_sw - row_hi[:, None, None], 0.0)
            ).sum(axis=0)
            v_sw = np.where(
                can_up[js, None] & can_dn[None, ls]
                & (js[:, None] != ls[None, :]),
                v_sw,
                np.inf,
            )
        else:
            v_sw = np.full((1, 1), np.inf)

        best_v = min(v_up.min(), v_dn.min(), v_sw.min())
        if best_v >= viol - TOL:
            return None  # no move strictly reduces violation
        # among near-best violation reducers, prefer the cheapest objective
        if best_v == v_sw.min():
            d_obj = np.where(
                v_sw <= best_v + TOL, ci[js][:, None] - ci[ls][None, :], np.inf
            )
            jj, ll = np.unravel_index(int(np.argmin(d_obj)), d_obj.shape)
            j, l = int(js[jj]), int(ls[ll])
            x[int_idx[j]] += 1
            x[int_idx[l]] -= 1
            act += Wi[:, j] - Wi[:, l]
        elif best_v == v_up.min():
            j = int(np.argmin(np.where(v_up <= best_v + TOL, ci, np.inf)))
            x[int_idx[j]] += 1
            act += Wi[:, j]
        else:
            j = int(np.argmin(np.where(v_dn <= best_v + TOL, -ci, np.inf)))
            x[int_idx[j]] -= 1
            act -= Wi[:, j]
        viol = violation(act)
    return None


class _AssignStruct:
    """Detected 2-regular equality structure (assignment family).

    Each column has 0/1 coefficients in exactly two all-equality rows with
    RHS 1, and those rows 2-color into sides A and B — the bipartite
    assignment structure.  Single ±1 moves or swaps always break two
    equality rows, so the minimal feasibility-preserving move is a 2x2
    CYCLE: two chosen cells (a1,b1),(a2,b2) -> (a1,b2),(a2,b1).
    """

    __slots__ = ("sideA", "sideB", "colA", "colB", "pair2col", "ineq_rows")

    def __init__(self, sideA, sideB, colA, colB, pair2col, ineq_rows):
        self.sideA = sideA
        self.sideB = sideB
        self.colA = colA  # (n,) side-A index per column
        self.colB = colB  # (n,) side-B index per column
        self.pair2col = pair2col  # (|A|, |B|) column id or -1
        self.ineq_rows = ineq_rows  # non-equality row indices


def detect_assignment(Wx, lo, hi) -> Optional[_AssignStruct]:
    """Detect the assignment structure or return None (cheap, exact)."""
    m, n = Wx.shape
    row_lo, row_hi = lo[n:], hi[n:]
    eq = np.isfinite(row_lo) & (row_lo == row_hi)
    eqi = np.flatnonzero(eq)
    if eqi.size < 2:
        return None
    E = Wx[eqi]
    if not np.all((E == 0) | (E == 1)) or not np.all(row_lo[eqi] == 1.0):
        return None
    if not np.all(E.sum(axis=0) == 2):
        return None
    if not (np.all(lo[:n] == 0) and np.all(hi[:n] == 1)):
        return None
    # 2-color the equality rows: rows sharing a column get opposite colors
    color = np.full(eqi.size, -1, dtype=np.int64)
    first = np.argmax(E, axis=0)  # first row of each column
    second = E.shape[0] - 1 - np.argmax(E[::-1], axis=0)
    color[first[0]] = 0
    for _ in range(eqi.size):
        changed = False
        for j in range(n):
            a, b = first[j], second[j]
            if color[a] >= 0 and color[b] < 0:
                color[b] = 1 - color[a]
                changed = True
            elif color[b] >= 0 and color[a] < 0:
                color[a] = 1 - color[b]
                changed = True
            elif color[a] >= 0 and color[a] == color[b]:
                return None  # odd structure: not bipartite
        if not changed:
            break
    if np.any(color < 0):
        return None  # disconnected: bail (could color per component)
    sideA = np.flatnonzero(color == 0)
    sideB = np.flatnonzero(color == 1)
    posA = np.full(eqi.size, -1, dtype=np.int64)
    posB = np.full(eqi.size, -1, dtype=np.int64)
    posA[sideA] = np.arange(sideA.size)
    posB[sideB] = np.arange(sideB.size)
    colA = np.where(color[first] == 0, posA[first], posA[second])
    colB = np.where(color[first] == 1, posB[first], posB[second])
    if np.any(colA < 0) or np.any(colB < 0):
        return None
    pair2col = np.full((sideA.size, sideB.size), -1, dtype=np.int64)
    pair2col[colA, colB] = np.arange(n)
    ineq_rows = np.flatnonzero(~eq)
    return _AssignStruct(eqi[sideA], eqi[sideB], colA, colB, pair2col, ineq_rows)


def cycle_improve(
    Wx: np.ndarray,
    c: np.ndarray,
    lo: np.ndarray,
    hi: np.ndarray,
    x0: np.ndarray,
    struct: _AssignStruct,
    max_moves: int = 40,
) -> Optional[np.ndarray]:
    """Repair + improve an assignment point by best 2x2 cycle moves.

    Phase 1 (repair): while any inequality row is violated, apply the cycle
    that most reduces total violation (ties: objective) — each move must
    strictly reduce violation, so it terminates.  Phase 2 (polish): apply
    the best objective-improving cycle that keeps feasibility until a local
    optimum.  Returns the final point (feasible), or None if repair fails.

    This is the assignment-family counterpart of ``repair``/``local_search``
    (whose single swaps always break two equality rows here).  All O(k²)
    pair work is vectorised over the k = |assignment| chosen cells.
    """
    n = Wx.shape[1]
    x = np.asarray(x0, dtype=np.float64).copy()
    x[:n] = np.rint(x[:n])
    Wi = Wx[struct.ineq_rows]  # (mi, n)
    r_lo = lo[n:][struct.ineq_rows]
    r_hi = hi[n:][struct.ineq_rows]

    def viol_of(a):
        return np.maximum(r_lo - a, 0.0).sum() + np.maximum(a - r_hi, 0.0).sum()

    for _ in range(max_moves):
        ones = np.flatnonzero(x > 0.5)
        k = ones.size
        if k < 2:
            break
        act = Wi @ x
        viol = viol_of(act)
        a_of = struct.colA[ones]  # (k,)
        b_of = struct.colB[ones]
        # cross columns for every pair (i, j): cell (a_i, b_j)
        cross = struct.pair2col[a_of[:, None], b_of[None, :]]  # (k, k)
        valid = (cross >= 0) & (struct.pair2col[a_of, b_of][:, None] >= 0)
        np.fill_diagonal(valid, False)
        # pair (i, j) move: drop ones[i], ones[j]; add cross[i,j], cross[j,i]
        valid &= cross.T >= 0
        safe = np.where(cross >= 0, cross, 0)
        dW = (
            Wi[:, safe]  # (mi, k, k) add (a_i, b_j)
            + np.transpose(Wi[:, safe], (0, 2, 1))  # add (a_j, b_i)
            - Wi[:, ones][:, :, None]
            - Wi[:, ones][:, None, :]
        )
        act_new = act[:, None, None] + dW
        v_new = (
            np.maximum(r_lo[:, None, None] - act_new, 0.0)
            + np.maximum(act_new - r_hi[:, None, None], 0.0)
        ).sum(axis=0)
        dc = (
            c[safe] + c[safe].T - c[ones][:, None] - c[ones][None, :]
        )
        v_new = np.where(valid, v_new, np.inf)
        if viol > TOL:
            best_v = v_new.min()
            if best_v >= viol - TOL:
                return None  # repair stuck
            cand = np.where(v_new <= best_v + TOL, dc, np.inf)
            i, j = np.unravel_index(int(np.argmin(cand)), cand.shape)
        else:
            gain = np.where(v_new <= TOL, dc, np.inf)
            i, j = np.unravel_index(int(np.argmin(gain)), gain.shape)
            if gain[i, j] >= -TOL:
                return x  # local optimum, feasible
        x[ones[i]] = 0.0
        x[ones[j]] = 0.0
        x[cross[i, j]] = 1.0
        x[cross[j, i]] = 1.0
    return x if viol_of(Wi @ x) <= TOL else None


def local_search(
    Wx: np.ndarray,
    c: np.ndarray,
    lo: np.ndarray,
    hi: np.ndarray,
    x0: np.ndarray,
    int_idx: np.ndarray,
    max_moves: int = 200,
) -> Tuple[np.ndarray, float]:
    """Improve a feasible integer point by best-improving unit moves/swaps.

    Returns (x, value); x0 must already be feasible.  Beyond
    ``SWAP_FULL_LIMIT`` integer variables, the all-pairs swap scan is
    restricted to the ``SWAP_CAND`` cheapest-to-raise and costliest-to-lower
    columns (an improving swap needs c[j] < c[l]) so a single round stays
    ~O(m·K²) instead of O(m·n²) — at 2AP40 scale (n=1600) the full tensor
    is 1.7 GB/round and was the dominant cost of the whole solve.
    """
    n = Wx.shape[1]
    m = Wx.shape[0]
    x = np.asarray(x0, dtype=np.float64).copy()
    act = Wx @ x
    val = float(c @ x)
    if int_idx.size == 0:
        return x, val
    Wi = Wx[:, int_idx]  # (m, ni)
    ci = c[int_idx]
    lo_x = lo[int_idx]
    hi_x = hi[int_idx]
    row_lo = lo[n:]
    row_hi = hi[n:]
    ni = int_idx.size

    for _ in range(max_moves):
        can_up = x[int_idx] + 1 <= hi_x + TOL
        can_dn = x[int_idx] - 1 >= lo_x - TOL
        # single +1 moves: act + Wi[:, j]
        act_up = act[:, None] + Wi  # (m, ni)
        ok_up = can_up & (
            (act_up >= row_lo[:, None] - TOL) & (act_up <= row_hi[:, None] + TOL)
        ).all(axis=0)
        act_dn = act[:, None] - Wi
        ok_dn = can_dn & (
            (act_dn >= row_lo[:, None] - TOL) & (act_dn <= row_hi[:, None] + TOL)
        ).all(axis=0)
        gain_up = np.where(ok_up, ci, np.inf)  # minimise: want negative
        gain_dn = np.where(ok_dn, -ci, np.inf)

        # pair swaps x_j += 1, x_l -= 1: act + Wi[:,j] - Wi[:,l]
        if ni <= SWAP_FULL_LIMIT:
            js = ls = np.arange(ni)
        else:
            # improving swap needs ci[j] < ci[l]: scan the K cheapest
            # raisable j's against the K costliest lowerable l's
            ju = np.flatnonzero(can_up)
            ld = np.flatnonzero(can_dn)
            js = ju[np.argsort(ci[ju])[:SWAP_CAND]] if ju.size else ju
            ls = ld[np.argsort(-ci[ld])[:SWAP_CAND]] if ld.size else ld
        if js.size and ls.size:
            act_sw = act_up[:, js, None] - Wi[:, None, ls]
            ok_sw = (
                (act_sw >= row_lo[:, None, None] - TOL)
                & (act_sw <= row_hi[:, None, None] + TOL)
            ).all(axis=0)
            ok_sw &= can_up[js, None] & can_dn[None, ls]
            ok_sw &= js[:, None] != ls[None, :]
            gain_sw = np.where(ok_sw, ci[js, None] - ci[None, ls], np.inf)
        else:
            gain_sw = np.full((1, 1), np.inf)

        best_up = gain_up.min()
        best_dn = gain_dn.min()
        best_sw = gain_sw.min()
        best = min(best_up, best_dn, best_sw)
        if best >= -TOL:
            break
        if best == best_up:
            j = int(np.argmin(gain_up))
            x[int_idx[j]] += 1
            act += Wi[:, j]
        elif best == best_dn:
            j = int(np.argmin(gain_dn))
            x[int_idx[j]] -= 1
            act -= Wi[:, j]
        else:
            jj, ll = np.unravel_index(int(np.argmin(gain_sw)), gain_sw.shape)
            j, l = int(js[jj]), int(ls[ll])
            x[int_idx[j]] += 1
            x[int_idx[l]] -= 1
            act += Wi[:, j] - Wi[:, l]
        val += best
    return x, float(c @ x)

"""The plain reference for bi-objective knapsacks with one capacity row:
dense dynamic programmes over exact integer tables, in plain PyTorch, on
the card where there is one and on the CPU in the tests.  It reaches the sizes at which ``reference_dp``'s states are too
many to compare, and it imports nothing of the program and takes nothing the
program made: it works from the instance's own values, weights and capacity.

The front (``weak=False``) comes from the table

    g[c, t] = max { x(T) : T a subset of weight <= c with t(T) == t }

over rows c = 0 .. cap and one column for each value t can take.  ``t``,
the table's value axis, is the objective with the larger value sum over the
items that fit, objective 1 where the sums tie, and ``x`` is the other: the
program's K4 (``kp_front.detect_kp2``) puts the smaller sum on its axis,
objective 0 on a tie, so the two never share a table's layout or its reading
off.  Each item (w, a, b), with a its t-value and b its x-value, sets

    g[c, t] = max(g[c, t], g[c - w, t - a] + b)

in place, by blocks of rows from the last row down: a block's candidate is
worked out whole from the table before the block is written, and it reads
rows that no earlier block of the item has written, so every cell reads the
previous item's values and no candidate the size of the table is made.  An
unreachable cell holds a value below 0 (``NEG`` plus some values, which the
checked value range keeps below 0), a reachable one x less the least x any
subset has, at least 0: so the maximum needs no test of reachability.  The
front is read off row c = cap: the columns whose best x beats the best x of
every larger t.

The weakly nondominated set (``weak=True``: the points no feasible point
beats in both objectives) holds points that are not the best x of their t,
which row c = cap does not keep.  So it comes from a second table, over the
two values,

    h[t, x] = min { w(T) : t(T) == t, x(T) == x },

updated item by item in place the same way (from the last row down, or from
the first row up for an item whose t-value is below 0); its points are the
cells with h <= cap, and the weak set those points whose x is at least the
largest x of any point with a larger t.

Both tables' columns stop at the largest value a feasible subset reaches (a
one-row programme over the capacity): a partial subset past it weighs more
than the capacity, and so does every subset that contains it.  Sums are
exact: int32 where every value a cell can hold is checked to fit, int64
otherwise."""

from __future__ import annotations

import math

import numpy as np
import torch

#: the most cells one block's candidate holds
BLOCK_CELLS = 1 << 26
#: ``g``'s unreachable mark and ``h``'s unreachable weight, by table type
NEG = {torch.int32: -(1 << 30), torch.int64: -(1 << 62)}
FAR = {torch.int32: 1 << 30, torch.int64: 1 << 62}


def _dtype(span: int) -> torch.dtype:
    """int32 where a value range of ``span`` fits beside the marks, else
    int64."""
    return torch.int32 if span < (1 << 30) - 1 else torch.int64


def sweep(table: torch.Tensor, dr: int, dc: int, add: int, better) -> None:
    """``table[r, s] = better(table[r, s], table[r - dr, s - dc] + add)`` for
    every cell whose source lies in the table, in place, each cell reading
    the table as it was before the call.  Blocks of rows run away from the
    rows they read: from the last down for ``dr > 0``, from the first up
    otherwise."""
    rows, cols = table.shape
    if abs(dr) >= rows or abs(dc) >= cols:
        return
    put = slice(max(dc, 0), cols + min(dc, 0))
    take = slice(max(-dc, 0), cols - max(dc, 0))
    lo, hi = max(dr, 0), rows + min(dr, 0)
    step = max(1, BLOCK_CELLS // cols)
    if dr > 0:
        blocks = [(max(lo, r1 - step), r1) for r1 in range(hi, lo, -step)]
    else:
        blocks = [(r0, min(hi, r0 + step)) for r0 in range(lo, hi, step)]
    for r0, r1 in blocks:
        cand = table[r0 - dr:r1 - dr, take] + add
        target = table[r0:r1, put]
        better(target, cand, out=target)


def best_value(weights: np.ndarray, values: np.ndarray, cap: int, device) -> int:
    """The largest value of a subset of weight at most ``cap`` (cap >= 0):
    the one-row programme ``f[c] = max(f[c], f[c - w] + v)``."""
    f = torch.zeros(cap + 1, dtype=torch.int64, device=device)
    for w, v in zip(weights.tolist(), values.tolist()):
        cand = f[:cap + 1 - w] + v
        f[w:] = torch.maximum(f[w:], cand)
    return int(f[cap])


def value_axis(values: np.ndarray) -> int:
    """The objective on the table's value axis: of ``values`` (2, n), those
    of the items that fit, the row whose sizes sum larger, 1 on a tie."""
    spans = np.abs(values).sum(axis=1)
    return 0 if spans[0] > spans[1] else 1


class Axis:
    """One objective's range over the subsets that fit: ``lo`` the sum of
    its values below 0, ``hi`` the largest value a feasible subset has, and
    ``span`` its whole range, the sum of the values' sizes."""

    def __init__(self, values: np.ndarray, weights: np.ndarray, cap: int, device):
        self.values = values
        self.lo = int(np.minimum(values, 0).sum())
        self.span = int(np.abs(values).sum())
        self.hi = best_value(weights, values, cap, device)

    @property
    def size(self) -> int:
        return self.hi - self.lo + 1


def _front_table(w, t: Axis, x: Axis, cap: int, device) -> np.ndarray:
    """(t, x) of the front from the table g over (c, t)."""
    dtype = _dtype(x.span)
    g = torch.full((cap + 1, t.size), NEG[dtype], dtype=dtype, device=device)
    g[:, -t.lo] = -x.lo
    for wi, a, b in zip(w.tolist(), t.values.tolist(), x.values.tolist()):
        sweep(g, wi, a, b, torch.maximum)
    row = g[cap].to(torch.int64).cpu().numpy()
    del g
    # the best x of every larger t: -1 past the last column, and no reachable
    # cell is below 0
    later = np.append(np.maximum.accumulate(row[::-1])[::-1][1:], -1)
    cols = np.flatnonzero((row >= 0) & (row > later))
    return np.column_stack([cols + t.lo, row[cols] + x.lo])


def _weak_table(w, t: Axis, x: Axis, cap: int, device) -> np.ndarray:
    """(t, x) of the weakly nondominated set from the table h over (t, x)."""
    dtype = _dtype(int(w.sum()))
    h = torch.full((t.size, x.size), FAR[dtype], dtype=dtype, device=device)
    h[-t.lo, -x.lo] = 0
    for wi, a, b in zip(w.tolist(), t.values.tolist(), x.values.tolist()):
        sweep(h, a, b, wi, torch.minimum)
    step = max(1, BLOCK_CELLS // x.size)
    cols = torch.arange(x.size, device=device)
    last = torch.cat([torch.where(h[r:r + step] <= cap, cols, -1).amax(dim=1)
                      for r in range(0, t.size, step)]).cpu().numpy()
    # the largest x of a point with a larger t: -1 past the last row
    floor = torch.as_tensor(np.append(np.maximum.accumulate(last[::-1])[::-1][1:], -1),
                            device=device)
    found = []
    for r in range(0, t.size, step):
        keep = (h[r:r + step] <= cap) & (cols[None, :] >= floor[r:r + step, None])
        found.append(keep.nonzero().cpu().numpy() + [r, 0])
    del h
    tx = np.concatenate(found)
    return tx + [t.lo, x.lo]


def kp_front(values, weights, capacity, sense: str, weak: bool = False,
             device=None) -> np.ndarray:
    """The exact front (weak: the weakly nondominated set) of a knapsack
    with two objectives and one capacity row, as points (N, 2) sorted as
    ``reference.nondominated`` sorts them; ``sense`` "max" or "min";
    ``device`` by default the card where there is one, else the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    sign = 1 if sense == "max" else -1
    V = sign * np.asarray(values, dtype=np.int64)
    w = np.asarray(weights, dtype=np.int64)
    if V.shape[0] != 2:
        raise ValueError(f"reference_kp2 takes two objectives, not {V.shape[0]}")
    if (w < 0).any():
        raise ValueError("the dynamic programme needs non-negative weights")
    cap = math.floor(capacity)
    if cap < 0:
        return np.zeros((0, 2), dtype=np.int64)
    # an item heavier than the capacity is in no feasible subset
    fits = w <= cap
    V, w = V[:, fits], w[fits]
    # and no subset weighs more than all of them
    cap = min(cap, int(w.sum()))
    t_obj = value_axis(V)
    t, x = (Axis(V[j], w, cap, device) for j in (t_obj, 1 - t_obj))
    tx = (_weak_table if weak else _front_table)(w, t, x, cap, device)
    points = np.empty_like(tx)
    points[:, t_obj], points[:, 1 - t_obj] = tx[:, 0], tx[:, 1]
    points = sign * points
    return points[np.lexsort(points.T[::-1])]

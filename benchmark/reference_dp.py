"""The knapsack family's plain reference: the dynamic programme over items
(Nemhauser and Ullmann 1969; for k objectives, Bazgan, Hugot and
Vanderpooten 2009, C&OR 36(1):260-279), which reaches sizes whose 2**n
subsets ``reference.kp_points`` cannot list.

A state is a subset of the items seen so far: its weight, its objective
vector and the subset itself as a bit mask, its witness.  Each item merges
the states with the states plus that item, drops those over the capacity,
and drops every state that another state beats: weight no larger and every
value no smaller (``weak``: every value strictly larger), and of two equal
states the newer.  The completions of a dropped state are beaten by the
same completions of the state that beat it, so no point of the front (weak:
of the weakly nondominated set) is lost.  The front is the set that
``reference.nondominated`` gives of the states' objective vectors, taken by
``front_of``, and each of its points is worked out again from its witness
before it is returned.

Plain NumPy: sums in int64, and each comparison of two states' values in
unsigned 64-bit words (``Packing``).  It imports nothing of the program and
takes nothing the program made."""

from __future__ import annotations

import numpy as np

#: the most candidate pairs one comparison block holds
BLOCK_PAIRS = 1 << 16


class Packing:
    """Keys packed into unsigned 64-bit words, each field with a guard bit
    above it, so that one subtraction compares every field of two states:
    ``((a | guard) - b) & guard == guard`` exactly when each field of ``a``
    is at least ``b``'s.  No field borrows from the next, since each
    difference plus its guard bit is non-negative.  ``maxima``: each key's
    largest value; keys are non-negative."""

    def __init__(self, maxima):
        self.word, self.shift, used = [], [], [0]
        widths = [int(m).bit_length() + 1 for m in maxima]
        if max(widths) > 64:
            raise ValueError(f"a key of {max(widths) - 1} bits does not fit a word")
        for w in widths:
            if used[-1] + w > 64:
                used.append(0)
            self.word.append(len(used) - 1)
            self.shift.append(used[-1])
            used[-1] += w
        self.guard = np.zeros(len(used), dtype=np.uint64)
        for f, w in enumerate(widths):
            self.guard[self.word[f]] |= np.uint64(1 << (self.shift[f] + w - 1))

    def pack(self, keys: np.ndarray) -> np.ndarray:
        """(S, fields) int64 keys -> (S, words) uint64."""
        out = np.zeros((len(keys), len(self.guard)), dtype=np.uint64)
        for f in range(keys.shape[1]):
            out[:, self.word[f]] |= keys[:, f].astype(np.uint64) << np.uint64(self.shift[f])
        return out


def beaten(cand: np.ndarray, query: np.ndarray, ends: np.ndarray, packing: Packing) -> np.ndarray:
    """For each query (packed keys): is one of its candidates at least as
    large in every key?  Query i's candidates are ``cand[:ends[i]]``: in
    the dynamic programme the states no heavier, sorted by weight."""
    out = np.zeros(len(query), dtype=bool)
    order = np.argsort(ends, kind="stable")
    step = max(1, BLOCK_PAIRS // max(1, len(cand)))
    guard = cand | packing.guard
    for i in range(0, len(order), step):
        rows = order[i:i + step]
        end = ends[rows[-1]]
        if end == 0:
            continue
        hit = np.arange(end)[None, :] < ends[rows, None]
        for word, g in enumerate(packing.guard):
            d = guard[None, :end, word] - query[rows, None, word]
            d &= g
            hit &= d == g
        out[rows] = hit.any(axis=1)
    return out


def front_of(P: np.ndarray, weak: bool) -> np.ndarray:
    """The distinct rows of ``P`` (S, k) that no other row dominates, for
    maximisation (weak: that no row beats in every objective), in no order.
    A row that dominates another has a larger sum (weak: by k at least), so
    sorted by sum, a row's candidates are a prefix."""
    U = np.unique(P, axis=0)
    k = U.shape[1]
    s = U.sum(axis=1)
    order = np.argsort(-s, kind="stable")
    U, s = U[order], s[order]
    ends = np.searchsorted(-s, -(s + (k if weak else 1)), side="right")
    lo = U.min(axis=0)
    packing = Packing(U.max(axis=0) - lo + (1 if weak else 0))
    keys = packing.pack(U - lo)
    query = keys + packing.pack(np.ones((1, k), dtype=np.int64)) if weak else keys
    return U[~beaten(keys, query, ends, packing)]


def _equal_to_old(old: np.ndarray, new: np.ndarray) -> np.ndarray:
    """For each row of ``new``: is it a row of ``old``?  Rows within each
    array are distinct."""
    both = np.concatenate([old, new])
    order = np.lexsort(both.T[::-1])
    same = (both[order[1:]] == both[order[:-1]]).all(axis=1)
    out = np.zeros(len(new), dtype=bool)
    pair = np.maximum(order[1:][same], order[:-1][same])
    out[pair - len(old)] = True
    return out


def kp_states(values, weights, capacity, weak: bool = False) -> tuple:
    """The states left after the last item, for maximisation: objective
    vectors (S, k) and witnesses (S, words) uint64, bit i of the subset in
    word i // 64."""
    V = np.asarray(values, dtype=np.int64)
    w = np.asarray(weights, dtype=np.int64)
    k, n = V.shape
    if (w < 0).any():
        raise ValueError("the dynamic programme needs non-negative weights")
    cap = int(np.floor(capacity))
    lo = np.minimum(V, 0).sum(axis=1)
    packing = Packing(np.maximum(V, 0).sum(axis=1) - lo + (1 if weak else 0))
    # weak: a query's values are raised by one, so that "at least" reads
    # "strictly larger"
    lift = packing.pack(np.ones((1, k), dtype=np.int64))[0] if weak else 0

    W = np.zeros(1 if cap >= 0 else 0, dtype=np.int64)
    P = np.zeros((len(W), k), dtype=np.int64)
    M = np.zeros((len(W), (n + 63) // 64), dtype=np.uint64)
    K = packing.pack(P - lo)
    for j in range(n):
        fits = W + w[j] <= cap
        W2, P2, M2 = W[fits] + w[j], P[fits] + V[:, j], M[fits].copy()
        M2[:, j // 64] |= np.uint64(1 << (j % 64))
        K2 = packing.pack(P2 - lo)
        fresh = ~_equal_to_old(np.column_stack([W, P]), np.column_stack([W2, P2]))
        W2, P2, M2, K2 = W2[fresh], P2[fresh], M2[fresh], K2[fresh]
        Q, Q2 = K + lift, K2 + lift
        keep = ~beaten(K2, Q, np.searchsorted(W2, W, side="right"), packing)
        keep2 = ~beaten(K, Q2, np.searchsorted(W, W2, side="right"), packing)
        W = np.concatenate([W[keep], W2[keep2]])
        order = np.argsort(W, kind="stable")
        W = W[order]
        P = np.concatenate([P[keep], P2[keep2]])[order]
        M = np.concatenate([M[keep], M2[keep2]])[order]
        K = np.concatenate([K[keep], K2[keep2]])[order]
    return P, M


def kp_front(values, weights, capacity, sense: str, weak: bool = False) -> tuple:
    """The exact front (weak: the weakly nondominated set) of a knapsack,
    and a witness of each point: (points (N, k), subsets (N, n) of 0 and
    1), the points sorted as ``reference.nondominated`` sorts them.  Every
    point is checked against its witness before it is returned."""
    values = np.asarray(values, dtype=np.int64)
    weights = np.asarray(weights, dtype=np.int64)
    sign = 1 if sense == "max" else -1
    P, M = kp_states(sign * values, weights, capacity, weak)
    points = sign * front_of(P, weak) if len(P) else P
    points = points[np.lexsort(points.T[::-1])]
    first = {}
    for i, row in enumerate(map(tuple, sign * P)):
        first.setdefault(row, i)
    n = weights.shape[0]
    idx = np.array([first[tuple(p)] for p in points], dtype=np.int64)
    bits = np.arange(n)
    X = ((M[idx][:, bits // 64] >> (bits % 64).astype(np.uint64)) & np.uint64(1)).astype(np.int64)
    if not (np.all(X @ weights <= capacity) and np.array_equal(X @ values.T, points)):
        raise RuntimeError("a point of the dynamic programme does not follow from its witness")
    return points, X

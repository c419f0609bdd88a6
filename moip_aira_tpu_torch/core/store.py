"""Pareto-point / relaxation store.

Reference parity: src/solutions.{h,cpp} and src/result.{h,cpp}.

``Solutions.find`` implements the relaxation test of solutions.cpp:17-47: a
stored subproblem (its objective-bound vector ``ip`` and solved objective
vector ``result``) answers a query bound vector ``q`` when, for MIN,

* the stored box contains the query box:      stored.ip >= q   (elementwise)
* the stored optimum lies inside the query box: stored.result <= q

(the inequalities flip for MAX).  An *infeasible* stored box containing the
query box proves the query infeasible.  Because every stored result is the
lexicographic optimum of a downward-closed box, any hit returns exactly the
optimum of the queried subproblem.

Unlike the reference's O(store) linked-list scan per query (the hot loop noted
in SURVEY §2/C3), the store keeps fixed-capacity NumPy arrays — and queries
run against a DOMINANCE-ANTICHAIN INDEX instead of the raw insertion list:

* sign-fold the sense away (negate everything for MAX), so every relation
  becomes componentwise ``>=``;
* an infeasible entry answers queries through its k-dim key ``ip``; a
  feasible entry through its 2k-dim key ``(ip, -result)`` — in both cases a
  stored key answers query key ``q`` iff ``key >= q`` elementwise, and a
  stored key whose key is dominated by another stored key can NEVER be the
  only answer (the dominating key answers every query it answers), so the
  index keeps only the antichain of maximal keys;
* for the bi-objective infeasible index (2-dim keys) the antichain is a
  staircase kept sorted by key0, so a query is one binary search.

The raw insertion-ordered arrays are kept untouched underneath (they are the
output front and the merge/exchange payload); only find/find_batch go
through the index.  The C++ twin (native/moip_native.cpp) mirrors this
design; equivalence is pinned by tests/test_native.py and test_store.py.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from moip_aira_tpu_torch.sense import Sense
from moip_aira_tpu_torch.utils.trace import counted


class _DomIndex:
    """Antichain of maximal float keys under componentwise >=.

    ``add`` drops dominated keys both ways; ``covers`` answers "is the query
    key dominated by any stored key" and returns the payload row of one such
    key.  With 2-dim keys the antichain is a staircase sorted ascending by
    key0 (key1 then strictly descending), so queries binary-search.
    """

    __slots__ = ("dim", "_keys", "_rows", "_n")

    def __init__(self, dim: int, capacity: int = 64):
        self.dim = dim
        self._keys = np.empty((capacity, dim), dtype=np.float64)
        self._rows = np.empty(capacity, dtype=np.int64)
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def add(self, key: np.ndarray, row: int) -> None:
        n = self._n
        keys = self._keys[:n]
        if n:
            if (keys >= key).all(axis=1).any():
                return  # dominated (or duplicate): never the only answer
            dead = (key >= keys).all(axis=1)
            if dead.any():
                keep = ~dead
                m = int(keep.sum())
                self._keys[:m] = keys[keep]
                self._rows[:m] = self._rows[:n][keep]
                n = self._n = m
        if n == self._keys.shape[0]:
            cap = max(2 * n, 64)
            self._keys = np.resize(self._keys, (cap, self.dim))
            self._rows = np.resize(self._rows, cap)
        if self.dim == 2:
            # staircase order: ascending key0 (antichain => descending key1)
            i = int(np.searchsorted(self._keys[:n, 0], key[0]))
            self._keys[i + 1 : n + 1] = self._keys[i:n]
            self._rows[i + 1 : n + 1] = self._rows[i:n]
            self._keys[i] = key
            self._rows[i] = row
        else:
            self._keys[n] = key
            self._rows[n] = row
        self._n = n + 1

    def covers(self, q: np.ndarray) -> int:
        """Row payload of a stored key with key >= q, else -1."""
        n = self._n
        if n == 0:
            return -1
        if self.dim == 2:
            # smallest key0 >= q0 has the LARGEST key1 among eligible keys
            i = int(np.searchsorted(self._keys[:n, 0], q[0]))
            if i < n and self._keys[i, 1] >= q[1]:
                return int(self._rows[i])
            return -1
        hit = (self._keys[:n] >= q).all(axis=1)
        j = int(hit.argmax())
        return int(self._rows[j]) if hit[j] else -1

    def covers_batch(self, Q: np.ndarray) -> np.ndarray:
        """(B,) payload rows (-1 where uncovered)."""
        B = Q.shape[0]
        out = np.full(B, -1, dtype=np.int64)
        n = self._n
        if n == 0 or B == 0:
            return out
        if self.dim == 2:
            i = np.searchsorted(self._keys[:n, 0], Q[:, 0])
            ok = i < n
            ii = np.minimum(i, n - 1)
            ok &= self._keys[ii, 1] >= Q[:, 1]
            out[ok] = self._rows[ii[ok]]
            return out
        hit = (self._keys[None, :n] >= Q[:, None, :]).all(axis=2)  # (B, n)
        any_ = hit.any(axis=1)
        first = hit.argmax(axis=1)
        out[any_] = self._rows[:n][first[any_]]
        return out


class Result:
    """One stored subproblem outcome (reference src/result.h:10-20)."""

    __slots__ = ("ip", "result", "infeasible")

    def __init__(self, ip: np.ndarray, result: Optional[np.ndarray], infeasible: bool):
        self.ip = ip
        self.result = result
        self.infeasible = infeasible

    def sort_key(self):
        # Descending order for display (reference result.cpp:9-28).
        return tuple(-int(v) for v in self.result)

    def __repr__(self) -> str:
        if self.infeasible:
            return f"Result(ip={self.ip}, infeasible)"
        return f"Result(ip={self.ip}, result={self.result})"


class Solutions:
    """Vectorised relaxation store with amortised-growth arrays."""

    def __init__(self, objective_count: int, capacity: int = 256):
        self.objective_count = objective_count
        self._n = 0
        self._ips = np.empty((capacity, objective_count), dtype=np.float64)
        self._results = np.zeros((capacity, objective_count), dtype=np.int64)
        self._infeasible = np.empty(capacity, dtype=bool)
        # dominance-antichain query index (module docstring).  The sense is
        # only learned at the first find(); until then inserts stay raw and
        # the index is built lazily (and rebuilt after merge()).
        self._sense: Optional[Sense] = None
        self._idx_inf: Optional[_DomIndex] = None
        self._idx_feas: Optional[_DomIndex] = None
        self._idx_built = 0  # raw rows already reflected in the index

    def __len__(self) -> int:
        return self._n

    # -- index plumbing ------------------------------------------------------
    def _fold(self) -> float:
        return 1.0 if self._sense is Sense.MIN else -1.0

    def _index_row(self, i: int) -> None:
        s = self._fold()
        if self._infeasible[i]:
            self._idx_inf.add(s * self._ips[i], i)
        else:
            key = np.concatenate(
                [s * self._ips[i], -s * self._results[i].astype(np.float64)]
            )
            self._idx_feas.add(key, i)

    def _ensure_index(self, sense: Sense) -> None:
        if self._sense is not sense or self._idx_inf is None:
            self._sense = sense
            k = self.objective_count
            self._idx_inf = _DomIndex(k)
            self._idx_feas = _DomIndex(2 * k)
            self._idx_built = 0
        while self._idx_built < self._n:
            self._index_row(self._idx_built)
            self._idx_built += 1

    # -- growth ------------------------------------------------------------
    def _ensure(self, extra: int) -> None:
        need = self._n + extra
        cap = self._ips.shape[0]
        if need <= cap:
            return
        while cap < need:
            cap *= 2
        self._ips = np.resize(self._ips, (cap, self.objective_count))
        self._results = np.resize(self._results, (cap, self.objective_count))
        self._infeasible = np.resize(self._infeasible, cap)

    # -- reference API -----------------------------------------------------
    @counted("store.insert")
    def insert(self, ip, result, infeasible: bool) -> None:
        """Store a solved subproblem (reference solutions.cpp:82-101)."""
        self._ensure(1)
        i = self._n
        self._ips[i] = np.asarray(ip, dtype=np.float64)
        if infeasible:
            self._results[i] = 0
        else:
            self._results[i] = np.asarray(result, dtype=np.int64)
        self._infeasible[i] = infeasible
        self._n = i + 1
        if self._sense is not None and self._idx_built == i:
            self._index_row(i)
            self._idx_built = i + 1

    @counted("store.find")
    def find(self, ip, sense: Sense) -> Optional[Result]:
        """Return a stored relaxation answering the query, else None."""
        if self._n == 0:
            return None
        self._ensure_index(sense)
        s = self._fold()
        q = s * np.asarray(ip, dtype=np.float64)
        i = self._idx_inf.covers(q)
        if i >= 0:
            return Result(self._ips[i], None, True)
        i = self._idx_feas.covers(np.concatenate([q, -q]))
        if i >= 0:
            return Result(self._ips[i], self._results[i].copy(), False)
        return None

    def find_batch(self, queries: np.ndarray, sense: Sense):
        """Answer B queries at once.

        Returns (hit_mask (B,), infeasible (B,), results (B, k)).  Rows with
        hit_mask False have undefined results.
        """
        B = queries.shape[0]
        k = self.objective_count
        hit = np.zeros(B, dtype=bool)
        infeas = np.zeros(B, dtype=bool)
        out = np.zeros((B, k), dtype=np.int64)
        if self._n == 0 or B == 0:
            return hit, infeas, out
        self._ensure_index(sense)
        s = self._fold()
        Q = s * np.asarray(queries, dtype=np.float64)
        ri = self._idx_inf.covers_batch(Q)
        rf = self._idx_feas.covers_batch(np.concatenate([Q, -Q], axis=1))
        infeas = ri >= 0
        hit = infeas | (rf >= 0)
        feas_hit = ~infeas & (rf >= 0)
        out[feas_hit] = self._results[rf[feas_hit]]
        return hit, infeas, out

    @counted("store.merge")
    def merge(self, other: "Solutions") -> None:
        """Splice another store into this one (reference solutions.h:41-44)."""
        m = other._n
        self._ensure(m)
        self._ips[self._n : self._n + m] = other._ips[:m]
        self._results[self._n : self._n + m] = other._results[:m]
        self._infeasible[self._n : self._n + m] = other._infeasible[:m]
        self._n += m
        other._n = 0
        # absorbed rows enter the index lazily on the next find(); the
        # drained donor's index must not outlive its raw rows
        other._sense = None
        other._idx_inf = other._idx_feas = None
        other._idx_built = 0

    def feasible_points(self) -> np.ndarray:
        """All stored feasible objective vectors, shape (f, k)."""
        mask = ~self._infeasible[: self._n]
        return self._results[: self._n][mask]

    def sorted_unique_points(self) -> np.ndarray:
        """Feasible points, descending-lexicographic, deduplicated.

        Reference solutions.h:54-57 + result.cpp:9-46 (sort is descending so
        the output file lists big first coordinates first).
        """
        pts = self.feasible_points()
        if pts.shape[0] == 0:
            return pts
        order = np.lexsort(tuple(pts[:, i] for i in range(pts.shape[1] - 1, -1, -1)))
        pts = pts[order[::-1]]
        keep = np.ones(pts.shape[0], dtype=bool)
        keep[1:] = (pts[1:] != pts[:-1]).any(axis=1)
        return pts[keep]

    def __iter__(self) -> Iterator[Result]:
        for i in range(self._n):
            if self._infeasible[i]:
                yield Result(self._ips[i], None, True)
            else:
                yield Result(self._ips[i], self._results[i], False)

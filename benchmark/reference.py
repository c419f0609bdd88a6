"""The plain reference: each instance's exact nondominated set, worked out
in NumPy or plain PyTorch from the instance's own coefficients.

It imports nothing of the program and takes nothing the program made.  A
knapsack with two objectives takes the dense tables of ``reference_kp2.py``
(PyTorch, on the card where there is one), which reach the sizes the
program's own dense programme takes; any other knapsack takes the dynamic
programme over items in ``reference_dp.py``, which reaches sizes whose 2**n
subsets are too many to list.  ``kp_points`` lists them all, for the tests
that hold both programmes to it.  An assignment's front is taken from its n!
assignments, which ``ap_points`` lists as every pairing of an assignment of
the first half of the rows with one of the other half to the columns left.

A point is the vector of objective values of a solution; the front is the
set of points no other point dominates.  ``weak=True`` gives the weakly
nondominated set instead (the points no other point beats in every
objective), which is what a front looks like when the lexicographic stages
that break ties are left out: ``control.py`` puts it in the program's
place."""

from __future__ import annotations

import itertools
import re

import numpy as np

import reference_dp
import reference_kp2

#: the largest grid ``nondominated`` marks points in; a larger range takes
#: the pairwise test
GRID_CELLS = 1 << 25


def kp_points(values: np.ndarray, weights: np.ndarray, capacity: float) -> np.ndarray:
    """Objective vectors (N, k) of every subset within the capacity."""
    n = weights.shape[0]
    X = (np.arange(1 << n)[:, None] >> np.arange(n)[None, :]) & 1
    feasible = X @ weights <= capacity
    return X[feasible] @ values.T


def ap_points(costs: np.ndarray) -> np.ndarray:
    """Objective vectors (n!, k) of every assignment of rows to columns."""
    k, n, _ = costs.shape
    h = n // 2
    full = (1 << n) - 1

    def halves(rows):
        """Every injective map of ``rows`` into the columns: the columns'
        bit mask and the objective vector."""
        maps = np.array(list(itertools.permutations(range(n), len(rows))), dtype=np.int64)
        if maps.size == 0:
            return np.zeros(1, np.int64), np.zeros((1, k), np.int64)
        mask = np.bitwise_or.reduce(1 << maps, axis=1)
        vec = sum(costs[:, r, maps[:, i]] for i, r in enumerate(rows)).T
        return mask, vec

    mask_a, vec_a = halves(list(range(h)))
    mask_b, vec_b = halves(list(range(h, n)))
    order_b = np.argsort(mask_b, kind="stable")
    mask_b, vec_b = mask_b[order_b], vec_b[order_b]
    out = []
    for mask in np.unique(mask_a):
        a = vec_a[mask_a == mask]
        lo, hi = np.searchsorted(mask_b, [full ^ mask, (full ^ mask) + 1])
        b = vec_b[lo:hi]
        out.append((a[:, None, :] + b[None, :, :]).reshape(-1, k))
    return np.concatenate(out)


def nondominated(points: np.ndarray, sense: str, weak: bool = False) -> np.ndarray:
    """The distinct points of ``points`` (N, k) that no other point
    dominates, for "max" or "min", sorted; ``weak``: those no point beats
    in every objective."""
    P = np.asarray(points, dtype=np.int64)
    if sense == "max":
        P = -P
    lo = P.min(axis=0)
    span = P.max(axis=0) - lo + 1
    if int(np.prod(span.astype(np.float64))) <= GRID_CELLS:
        front = _grid_front(P - lo, span, weak) + lo
    else:
        front = _pairwise_front(np.unique(P, axis=0), weak)
    if sense == "max":
        front = -front
    return front[np.lexsort(front.T[::-1])]


def _grid_front(P: np.ndarray, span: np.ndarray, weak: bool) -> np.ndarray:
    """Minimisation on a grid: ``below[x]`` says whether some point lies
    at or below x in every objective.  A point is dominated when some other
    point lies at or below it less one in one objective (weak: in all)."""
    k = P.shape[1]
    present = np.zeros(tuple(span), dtype=bool)
    present[tuple(P.T)] = True
    below = present.copy()
    for axis in range(k):
        np.logical_or.accumulate(below, axis=axis, out=below)
    cand = np.argwhere(present)
    steps = [np.ones(k, np.int64)] if weak else list(np.eye(k, dtype=np.int64))
    keep = np.ones(len(cand), dtype=bool)
    for step in steps:
        q = cand - step
        inside = (q >= 0).all(axis=1)
        hit = np.zeros(len(cand), dtype=bool)
        hit[inside] = below[tuple(q[inside].T)]
        keep &= ~hit
    return cand[keep]


def _pairwise_front(P: np.ndarray, weak: bool, block: int = 512) -> np.ndarray:
    """Minimisation over distinct points, by comparing every pair."""
    keep = np.ones(len(P), dtype=bool)
    for i0 in range(0, len(P), block):
        a = P[i0:i0 + block, None, :]
        if weak:
            beaten = (P[None] < a).all(axis=2).any(axis=1)
        else:
            beaten = ((P[None] <= a).all(axis=2) & (P[None] < a).any(axis=2)).any(axis=1)
        keep[i0:i0 + block] = ~beaten
    return P[keep]


def front(inst, weak: bool = False) -> np.ndarray:
    """The exact front (weak: the weakly nondominated set) of an
    ``instances.Instance``."""
    if inst.family == "knapsack" and inst.values.shape[0] == 2:
        return reference_kp2.kp_front(inst.values, inst.weights, inst.capacity, inst.sense,
                                      weak)
    if inst.family == "knapsack":
        return reference_dp.kp_front(inst.values, inst.weights, inst.capacity, inst.sense,
                                     weak)[0]
    if inst.family == "assignment":
        return nondominated(ap_points(inst.costs), inst.sense, weak)
    raise ValueError(f"no reference for family {inst.family!r}")


# -- the benchmark's own reading of the two families' LP text ----------------

_TERM = re.compile(r"^(?:(-?\d+(?:\.\d+)?)\s+)?([A-Za-z_][\w#]*)$")


def parse_lp(text: str) -> dict:
    """The rows of a knapsack or assignment LP as the families write them
    (objectives as the last rows, the last right-hand side their count):
    {"sense", "names", "rows": [(coefs dict, op, rhs)], "objectives"}."""
    sense, rows, names, section = None, [], [], None
    for raw in text.splitlines():
        line = raw.split("\\", 1)[0].strip()
        if not line:
            continue
        low = line.lower()
        if sense is None and low.split()[0] in ("maximize", "minimize"):
            sense = "max" if low.startswith("max") else "min"
            continue
        if low in ("s.t.", "subject to", "st"):
            section = "rows"
            continue
        if low in ("binary", "binaries"):
            section = "binary"
            continue
        if low == "end":
            break
        if section == "rows":
            m = re.match(r"^(.*?)\s*(<=|>=|=<|=>|<|>|=)\s*(-?[\d.]+)$", line)
            if m is None:
                raise ValueError(f"unreadable row: {line!r}")
            coefs = {}
            for term in m.group(1).split("+"):
                t = _TERM.match(term.strip())
                if t is None:
                    raise ValueError(f"unreadable term {term!r}")
                coefs[t.group(2)] = float(t.group(1) or 1)
            rows.append((coefs, m.group(2), float(m.group(3))))
        elif section == "binary":
            names.extend(line.split())
    k = int(rows[-1][2])
    return {"sense": sense, "names": names, "rows": rows, "objectives": k}


def instance_from_lp(text: str, name: str = "lp"):
    """An ``instances.Instance`` of the knapsack or assignment family from
    its LP text."""
    from instances import Instance

    lp = parse_lp(text)
    k, names, rows = lp["objectives"], lp["names"], lp["rows"]
    cons, objs = rows[:-k], rows[-k:]
    if all(op == "=" and rhs == 1 for _, op, rhs in cons):
        size = int(round(len(names) ** 0.5))
        costs = np.zeros((k, size, size), dtype=np.int64)
        for o, (coefs, _, _) in enumerate(objs):
            for var, c in coefs.items():
                i, j = (int(x) - 1 for x in re.match(r"^X(\d+)X(\d+)$", var).groups())
                costs[o, i, j] = int(c)
        return Instance(name, "assignment", lp["sense"], text, costs=costs)
    if len(cons) == 1 and cons[0][1] in ("<=", "<", "=<"):
        col = {v: i for i, v in enumerate(names)}
        weights = np.zeros(len(names), dtype=np.int64)
        for var, c in cons[0][0].items():
            weights[col[var]] = int(c)
        values = np.zeros((k, len(names)), dtype=np.int64)
        for o, (coefs, _, _) in enumerate(objs):
            for var, c in coefs.items():
                values[o, col[var]] = int(c)
        return Instance(name, "knapsack", lp["sense"], text, values=values, weights=weights,
                        capacity=cons[0][2])
    raise ValueError("neither a one-row knapsack nor an assignment LP")


def read_out(text: str) -> np.ndarray:
    """The points of a front file in the reference's ``.out`` layout."""
    pts = []
    for line in text.splitlines():
        parts = line.split()
        if parts and all(re.fullmatch(r"-?\d+", p) for p in parts):
            pts.append([int(p) for p in parts])
    return np.array(pts, dtype=np.int64)

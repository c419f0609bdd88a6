"""Adaptive parallel bound sweep — the TPU-shaped bi-objective front driver.

The AIRA epsilon ladder (engine/worker.py; reference aira.cpp:700-1840)
discovers the k=2 nondominated set SEQUENTIALLY: each round's objective
bound depends on the previous round's solved point, so a front of F points
needs ~F dependent rounds, and a device batch built from 1-2 workers runs
almost empty (measured on 2AP20: 124 fragment waves averaging 17 of 256
lanes).  That control-dependence is an artefact of walking the ladder one
rung at a time — not of the problem:

  For MIN objectives, the lexicographic optimum (f0, f1) of the box
  {obj1 <= b} is a nondominated point for ANY bound b, and it is the ONLY
  nondominated point with obj1 in [f1, b]  (a second such point p would
  have p0 > f0 — f0 is optimal under the bound — and p1 >= f1, so (f0, f1)
  would dominate it).  An infeasible bound b proves no point has obj1 <= b.

So the whole front is an INTERVAL-COVERING problem over the integer range
of obj1, and the driver runs it as T PARALLEL CHAINED LADDERS with no
round barrier: T seed bounds spread over the range solve concurrently
(every lane of the batched backend is an independent lexicographic IP);
each completed bound immediately streams its successor (its result value
minus one) into the pool through the backend's ``feeder`` hook; a chain
that walks into an already-covered interval dies and is re-seeded at the
top of the largest uncovered gap.  A front of F points costs ~F + T
lex-IPs total (each chain wastes at most its final collision) while the
device stays saturated until the last gap closes — no straggler tail
(measured on KP2D100: the round-barrier version idled through 11,941
mostly-empty waves).

Exactness: every emitted point is a full-permutation lexicographic optimum
of a downward-closed box (the exactness invariant), solved by
the same exact backend as the ladder; the covering argument above is what
makes the union COMPLETE.  Requires integer-valued objectives (the
reference's own standing assumption — it rounds every objective value,
aira.cpp:517).

Reference analogue: the EPP splitter (aira.cpp:1886-1990) statically cuts
the SAME range into one strip per thread; this driver is the adaptive,
work-stealing version of that idea.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from moip_aira_tpu_torch.problem import Problem
from moip_aira_tpu_torch.sense import Sense
from moip_aira_tpu_torch.solver.lex import LexRequest

_NEG = -(2**62)  # "covered all the way down" sentinel (infeasible bounds)


class SweepResult:
    __slots__ = ("points", "ip_count", "rounds", "batch_sizes")

    def __init__(self, points, ip_count, rounds, batch_sizes):
        self.points = points
        self.ip_count = ip_count
        self.rounds = rounds
        self.batch_sizes = batch_sizes


class _Cover:
    """Merged set of covered integer intervals (sorted, disjoint)."""

    def __init__(self):
        self.iv: List[List[int]] = []  # [lo, hi], sorted by lo

    def add(self, lo: int, hi: int) -> None:
        import bisect

        i = bisect.bisect_left([v[0] for v in self.iv], lo)
        # merge with the left neighbour too
        if i > 0 and self.iv[i - 1][1] >= lo - 1:
            i -= 1
        new_lo, new_hi = lo, hi
        j = i
        while j < len(self.iv) and self.iv[j][0] <= hi + 1:
            new_lo = min(new_lo, self.iv[j][0])
            new_hi = max(new_hi, self.iv[j][1])
            j += 1
        self.iv[i:j] = [[new_lo, new_hi]]

    def contains(self, w: int) -> bool:
        import bisect

        i = bisect.bisect_right([v[0] for v in self.iv], w) - 1
        return i >= 0 and self.iv[i][1] >= w

    def gaps(self, lo: int, hi: int) -> List[Tuple[int, int]]:
        """Uncovered sub-intervals of [lo, hi]."""
        out: List[Tuple[int, int]] = []
        cur = lo
        for a, b in self.iv:
            if b < cur:
                continue
            if a > hi:
                break
            if a > cur:
                out.append((cur, a - 1))
            cur = max(cur, b + 1)
            if cur > hi:
                return out
        if cur <= hi:
            out.append((cur, hi))
        return out


def _seed_bounds(gaps: List[Tuple[int, int]], budget: int) -> List[int]:
    """Up to ``budget`` bounds: every gap's top, extras spread by length."""
    bounds = [hi for (_lo, hi) in gaps]
    extra = budget - len(bounds)
    if extra > 0:
        total = sum(hi - lo for lo, hi in gaps)
        if total > 0:
            for lo, hi in gaps:
                share = int(round(extra * (hi - lo) / total))
                if share <= 0 or hi - lo < 1:
                    continue
                step = max(1, (hi - lo) // (share + 1))
                b = hi - step
                while b >= lo and len(bounds) < budget:
                    bounds.append(b)
                    b -= step
    return bounds[:budget]


def sweep_front(
    problem: Problem,
    backend,
    batch: int = 256,
) -> Optional[SweepResult]:
    """Exact bi-objective nondominated set by adaptive parallel bound sweep.

    Returns None when the driver does not apply (objcnt != 2, or a
    non-integral objective makes integer interval covering unsound).
    """
    p = problem
    if p.objcnt != 2:
        return None
    for j in range(2):
        if not (
            np.all(p.C[j] == np.rint(p.C[j]))
            and np.all(p.is_int[np.abs(p.C[j]) > 0])
        ):
            return None  # non-integral objective: interval steps unsound

    is_min = p.objsen is Sense.MIN
    sgn = 1 if is_min else -1
    rounds = 0
    batch_sizes: List[int] = []
    ip_count = 0
    pts: List[np.ndarray] = []

    free = p.initial_rhs()

    # ---- the two lexicographic extremes ------------------------------------
    rounds += 1
    batch_sizes.append(2)
    outs = backend.lex_solve_batch(
        [
            LexRequest(rhs=free.copy(), perm=[0, 1]),
            LexRequest(rhs=free.copy(), perm=[1, 0]),
        ]
    )
    ip_count += sum(o.ip_solves for o in outs)
    if outs[0].result is None:  # whole problem infeasible
        return SweepResult(
            np.zeros((0, 2), dtype=np.int64), ip_count, rounds, batch_sizes
        )
    L = np.asarray(outs[0].result, dtype=np.int64)  # min obj0 end
    R = np.asarray(outs[1].result, dtype=np.int64)  # min obj1 end
    pts.append(L)
    if not np.array_equal(L, R):
        pts.append(R)

    # work in SIGN-FOLDED obj1 units (w = sgn * obj1: tighter = smaller)
    Lw = int(sgn * L[1])
    Rw = int(sgn * R[1])
    lo_w, hi_w = Rw + 1, Lw - 1
    if lo_w > hi_w:
        return _finish(pts, ip_count, rounds, batch_sizes)

    cover = _Cover()
    in_flight: dict = {}  # req index (backend-side) -> bound value

    def _mk_req(b: int, hint=None) -> LexRequest:
        rhs = free.copy()
        rhs[1] = float(sgn * b)  # obj1 <= b (MIN) / >= -b (MAX)
        # the parent rung's optimum rides along as a repairable warm-
        # incumbent hint (solver/heuristics.py repair): it violates the new
        # bound by one front step, so a couple of greedy swaps turn it into
        # a near-optimal incumbent that collapses the child's B&B tree
        return LexRequest(rhs=rhs, perm=[0, 1], x_hint=hint)

    def _reseed() -> Optional[int]:
        """Top of the largest uncovered gap whose top no chain claims."""
        claimed = set(in_flight.values())
        best = None
        for lo, hi in cover.gaps(lo_w, hi_w):
            if hi in claimed:
                continue
            if best is None or hi - lo > best[1] - best[0]:
                best = (lo, hi)
        return best[1] if best else None

    def feeder(ri: int, out) -> List[LexRequest]:
        nonlocal ip_count
        b = in_flight.pop(ri, None)
        if b is None:
            return []
        ip_count += out.ip_solves
        if out.result is None:
            cover.add(_NEG, b)  # infeasible at b => infeasible below b
            cand = None
        else:
            r = np.asarray(out.result, dtype=np.int64)
            pts.append(r)
            w_r = int(sgn * r[1])
            cover.add(w_r, b)
            cand = w_r - 1  # the chain's next rung (the ladder step)
        hint = getattr(out, "x", None)
        if cand is None or cand < lo_w or cover.contains(cand) or (
            cand in in_flight.values()
        ):
            cand = _reseed()  # chain died: steal the largest open gap
            hint = None  # a reseeded gap top is unrelated to this point
        if cand is None:
            return []
        req = _mk_req(cand, hint=hint)
        # the backend assigns the new request the next index in ITS list;
        # track it by that convention (wave appends in order)
        in_flight[feeder.next_idx] = cand
        feeder.next_idx += 1
        return [req]

    # initial chain seeds: never denser than a quarter of the integer range
    # (integer fronts have >= 1-unit spacing; flooding short ranges only
    # solves duplicates)
    T = min(batch // 2, max(1, (hi_w - lo_w + 1) // 4))
    seeds = _seed_bounds(cover.gaps(lo_w, hi_w), T)
    reqs = [_mk_req(b) for b in seeds]
    feeder.next_idx = len(reqs)
    for i, b in enumerate(seeds):
        in_flight[i] = b

    rounds += 1
    batch_sizes.append(len(reqs))
    if getattr(backend, "supports_feeder", False):
        # every request (seed or fed) reaches feeder exactly once, which
        # counts its ip_solves — nothing to add afterwards
        backend.lex_solve_batch(reqs, feeder=feeder)
    else:
        # barrier emulation for backends without streaming (numpy / jax):
        # run the queue in batches, feed after each batch
        queue = list(range(len(reqs)))
        all_reqs = list(reqs)
        while queue:
            batch_out = backend.lex_solve_batch([all_reqs[i] for i in queue])
            rounds += 1
            batch_sizes.append(len(queue))
            nxt: List[int] = []
            for i, out in zip(queue, batch_out):
                if i < len(seeds):
                    ip_count += out.ip_solves
                    # seeds' feeder call must not double-count
                    out2 = out
                    new = feeder(i, _NoIps(out2))
                else:
                    new = feeder(i, out)
                for nr in new:
                    all_reqs.append(nr)
                    nxt.append(len(all_reqs) - 1)
            queue = nxt

    # any gap left would mean in_flight died out early — cannot happen
    # (every completion either covers its gap top or reseeds), but guard:
    leftover = cover.gaps(lo_w, hi_w)
    while leftover:
        rounds += 1
        bs = _seed_bounds(leftover, batch)
        batch_sizes.append(len(bs))
        outs = backend.lex_solve_batch([_mk_req(b) for b in bs])
        ip_count += sum(o.ip_solves for o in outs)
        for b, out in zip(bs, outs):
            if out.result is None:
                cover.add(_NEG, b)
            else:
                r = np.asarray(out.result, dtype=np.int64)
                pts.append(r)
                cover.add(int(sgn * r[1]), b)
        leftover = cover.gaps(lo_w, hi_w)

    return _finish(pts, ip_count, rounds, batch_sizes)


class _NoIps:
    """Outcome proxy reporting 0 ip_solves (already counted by the caller)."""

    __slots__ = ("result", "status", "ip_solves", "x")

    def __init__(self, out):
        self.result = out.result
        self.status = out.status
        self.ip_solves = 0
        self.x = getattr(out, "x", None)


def _finish(pts, ip_count, rounds, batch_sizes) -> SweepResult:
    arr = np.stack(pts)
    order = np.lexsort(tuple(arr[:, i] for i in range(arr.shape[1] - 1, -1, -1)))
    arr = arr[order[::-1]]
    keep = np.ones(arr.shape[0], dtype=bool)
    keep[1:] = (arr[1:] != arr[:-1]).any(axis=1)
    return SweepResult(arr[keep], ip_count, rounds, batch_sizes)

"""Exact host audit of device B&B fragments (K3: csrc/bb_fragment.cu, its
plain version solver/bb_torch.py).

The fragment kernel is a *speculative* searcher: its prune/close decisions
use f32 LP values.  Exactness (the exactness invariant: every value feeding a
B&B decision is f64-certified) is restored here:

1. ``replay_lane`` — deterministically replays the kernel's logged walk
   (branch variable / floor / first-child direction per record) to
   reconstruct every processed node's exact bounds, plus the set of nodes
   the fragment left OPEN (unexplored siblings, the pending node at a
   budget/tick stop).  The replay mirrors the kernel's eager
   backtrack-to-sibling semantics; open-node soundness does not depend on
   where inside a backtrack chain the kernel stopped (a partially-popped
   chain only ever *closes* fully-explored subtrees).

2. ``audit_records`` — given rigorous f64 certificates for every record
   (solver/verify.py interval bounds), classifies each kernel decision
   against the task's final VALIDATED incumbent: confirmed closures stay
   closed; anything not rigorously provable (failed certificate, dual bound
   short of the incumbent, iteration/depth trouble) is returned for exact
   host resolution.  Pruning soundness is checked against the final
   incumbent, which is valid regardless of the incumbent the kernel held
   when it pruned (the final one is never larger).

The caller (solver/wave.py fragment path) owns certification batching,
candidate validation and the exact host re-solves.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from moip_aira_tpu_torch.solver.bb_torch import (
    ACT_BRANCH,
    ACT_INFEAS,
    ACT_ITERLIM,
    ACT_LEAF,
    ACT_PRUNE,
    F_ACTION,
    F_DIR,
    F_FL,
    F_J,
    F_OBJ,
    F_STATUS,
)

INT_TOL = 1e-6


@dataclasses.dataclass
class LaneReplay:
    #: exact (lo, hi) bounds of every logged node, in record order
    node_lo: np.ndarray  # (nlog, nvar)
    node_hi: np.ndarray  # (nlog, nvar)
    #: nodes the fragment left unexplored: (lo, hi, parent_record or -1)
    open_nodes: List[Tuple[np.ndarray, np.ndarray, int]]
    #: True when the LAST open node is the one the lane was actively
    #: solving at its tick stop — its LP resumes from the lane's FINAL
    #: basis (kernel fin_basis/fin_atup outputs), not its parent's
    pending: bool = False
    #: per-record index of the BRANCH record that created the record's
    #: node (-1 = the fragment root).  A parent's logged basis is its
    #: node's claimed-OPTIMAL basis — one bound change away from the
    #: child, so it warm-starts the child's exact host LP far better
    #: than an ITERLIM record's own mid-solve basis.
    parent_rec: Optional[np.ndarray] = None  # (nlog,) int64


def replay_lane(
    root_lo: np.ndarray,
    root_hi: np.ndarray,
    recs: np.ndarray,  # (nlog, >=8) f32 scalar rows (F_* fields)
    nlog: int,
) -> LaneReplay:
    """Replay a lane's walk; bounds are STRUCTURAL-variable arrays."""
    lo = np.asarray(root_lo, dtype=np.float64).copy()
    hi = np.asarray(root_hi, dtype=np.float64).copy()
    nvar = lo.shape[0]
    node_lo = np.empty((nlog, nvar))
    node_hi = np.empty((nlog, nvar))
    parent_rec = np.full(nlog, -1, dtype=np.int64)
    # stack entries: [j, fl, old_lo, old_hi, down_first, state, parent_rec]
    stack: List[list] = []
    # the root is entered before the first record; if the lane stopped with
    # NO records (tick limit mid-first-LP) the root itself is still open
    pending = True
    for t in range(nlog):
        node_lo[t] = lo
        node_hi[t] = hi
        if stack:
            parent_rec[t] = stack[-1][6]
        act = int(recs[t, F_ACTION])
        j = int(recs[t, F_J])
        fl = float(recs[t, F_FL])
        down_first = recs[t, F_DIR] > 0.5
        if act == ACT_BRANCH:
            stack.append([j, fl, lo[j], hi[j], down_first, 0, t])
            if down_first:
                hi[j] = fl
            else:
                lo[j] = fl + 1.0
            pending = True
        else:
            # kernel backtracks: pop exhausted entries, switch the first
            # both-children-pending entry to its sibling
            pending = False
            while stack and stack[-1][5] == 1:
                j2, _fl2, ol, oh, _d2, _s, _p = stack.pop()
                lo[j2], hi[j2] = ol, oh
            if stack:
                e = stack[-1]
                j2, fl2, ol, oh, d2 = e[0], e[1], e[2], e[3], e[4]
                lo[j2], hi[j2] = ol, oh
                if d2:
                    lo[j2] = fl2 + 1.0  # first child was down; sibling up
                else:
                    hi[j2] = fl2
                e[5] = 1
                pending = True

    # ---- open nodes ------------------------------------------------------
    opens: List[Tuple[np.ndarray, np.ndarray, int]] = []
    lo2 = np.asarray(root_lo, dtype=np.float64).copy()
    hi2 = np.asarray(root_hi, dtype=np.float64).copy()
    last_parent = -1
    for j, fl, _ol, _oh, d2, state, prec in stack:
        if state == 0:
            sib_lo, sib_hi = lo2.copy(), hi2.copy()
            if d2:
                sib_lo[j] = fl + 1.0
            else:
                sib_hi[j] = fl
            opens.append((sib_lo, sib_hi, prec))
            if d2:
                hi2[j] = fl
            else:
                lo2[j] = fl + 1.0
        else:
            if d2:
                lo2[j] = fl + 1.0
            else:
                hi2[j] = fl
        last_parent = prec
    if pending:
        # the node the kernel was about to solve (or solving) when it
        # stopped; its bounds equal the replay cursor
        assert np.array_equal(lo2, lo) and np.array_equal(hi2, hi)
        opens.append((lo2.copy(), hi2.copy(), last_parent))
    return LaneReplay(
        node_lo=node_lo, node_hi=node_hi, open_nodes=opens, pending=pending,
        parent_rec=parent_rec,
    )


@dataclasses.dataclass
class RecordAudit:
    #: records (indices) whose closure failed rigor -> exact host resolution
    host_recs: List[int]
    #: records confirmed closed (diagnostics)
    confirmed: int
    #: rigorous per-record bound (ceil-tightened), used as child pb
    rec_pb: np.ndarray
    #: host_recs broken down by kernel action (diagnostics)
    why: dict = dataclasses.field(default_factory=dict)


def audit_records(
    recs: np.ndarray,  # (nlog, >=8)
    dual_lb: np.ndarray,  # (nlog,) rigorous f64 bound per record (+inf =
    #                       infeasibility certified, -inf = no bound)
    leaf_ok: np.ndarray,  # (nlog,) bool — leaf candidate validated exactly
    box_empty: np.ndarray,  # (nlog,) bool — lo > hi exactly (trivially empty)
    final_best: float,
    obj_int: bool,
) -> RecordAudit:
    """Classify every kernel decision against the validated incumbent."""
    nlog = recs.shape[0]
    eps = INT_TOL if obj_int else 1e-9
    rec_pb = np.where(
        np.isfinite(dual_lb),
        np.ceil(dual_lb - INT_TOL) if obj_int else dual_lb,
        dual_lb,
    )
    host_recs: List[int] = []
    confirmed = 0
    why = {"iterlim": 0, "infeas": 0, "prune": 0, "leaf": 0}
    for t in range(nlog):
        act = int(recs[t, F_ACTION])
        if act == ACT_BRANCH:
            continue  # no closure claimed; children tracked by the replay
        if act == ACT_ITERLIM:
            # the lane abandoned this node mid-LP, but its logged basis
            # still certifies a rigorous ANY-y dual bound (verify.py) — if
            # that already clears the incumbent, the node closes WITHOUT
            # finishing its LP (round-3: iterlim was ~75% of host records)
            if np.isfinite(rec_pb[t]) and rec_pb[t] >= final_best - eps:
                confirmed += 1
            else:
                host_recs.append(t)
                why["iterlim"] += 1
            continue
        if act == ACT_INFEAS:
            if box_empty[t] or dual_lb[t] == np.inf:
                confirmed += 1
            else:
                host_recs.append(t)
                why["infeas"] += 1
            continue
        # ACT_PRUNE / ACT_LEAF: closed iff nothing in the node can beat the
        # validated final incumbent
        closed = np.isfinite(rec_pb[t]) and rec_pb[t] >= final_best - eps
        if act == ACT_LEAF and not leaf_ok[t]:
            closed = False  # claimed optimum didn't validate: resolve exactly
        if closed:
            confirmed += 1
        else:
            host_recs.append(t)
            why["prune" if act == ACT_PRUNE else "leaf"] += 1
    return RecordAudit(
        host_recs=host_recs, confirmed=confirmed, rec_pb=rec_pb, why=why
    )

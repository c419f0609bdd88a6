"""Synergistic cluster decomposition — spreading and clustering modes.

Reference parity: src/cluster.{h,cpp}.  The recursive constructor partitions
``n_workers`` over the tree of objective orderings: at each level one shared
cell triple (share / bounds / limit) is allocated per sub-ordering position,
children that exchange a position get a lock group, and the ordering rotates
between children.  *Spreading* (default, cluster.cpp:98-180) divides workers
evenly over the ``n_obj_left`` sub-orderings; *clustering*
(cluster.cpp:181-223) fills one sub-ordering with up to (n_obj_left-1)!
workers before starting the next.

The emitted WorkerSpec wiring (which cell each worker reads bounds from /
publishes to, per objective) is exactly the reference's pointer graph; the
cells themselves are scheduler-round-synchronised values instead of raw
``int*`` (see engine/worker_spec.py).
"""

from __future__ import annotations

from math import factorial
from typing import List, Optional

from moip_aira_tpu_torch.engine.worker_spec import Cell, LockGroup, WorkerSpec
from moip_aira_tpu_torch.sense import INF, Sense


def build_cluster(
    n_workers: int,
    objcnt: int,
    sense: Sense,
    spread: bool = True,
) -> List[WorkerSpec]:
    """Top-level entry (reference aira.cpp:277-295)."""
    specs: List[WorkerSpec] = []
    _cluster(
        n_workers,
        objcnt,
        sense,
        spread,
        objcnt,
        list(range(objcnt)),
        [None] * objcnt,
        [None] * objcnt,
        [None] * objcnt,
        [None] * objcnt,
        specs,
        [None] * objcnt,
    )
    return specs


def _cluster(
    n_workers: int,
    objcnt: int,
    sense: Sense,
    spread: bool,
    n_obj_left: int,
    ordering: List[int],
    share_to: List[Optional[Cell]],
    share_from: List[Optional[Cell]],
    share_bounds: List[Optional[Cell]],
    share_limit: List[Optional[Cell]],
    specs: List[WorkerSpec],
    locks: List[Optional[LockGroup]],
) -> None:
    if n_workers == 1:
        # Leaf: emit a worker with the accumulated ordering (cluster.cpp:21-36)
        specs.append(
            WorkerSpec(
                id=len(specs),
                nobj=objcnt,
                perm=list(ordering),
                share_to=list(share_to),
                share_from=list(share_from),
                share_bounds=list(share_bounds),
                share_limit=list(share_limit),
                locks=list(locks),
                partnered=(n_obj_left == 1),
            )
        )
        return

    my_ordering = list(ordering)
    share_to = list(share_to)
    share_from = list(share_from)
    share_bounds = list(share_bounds)
    share_limit = list(share_limit)

    # fresh shared cells, one per sub-cluster position (cluster.cpp:54-75)
    new_shares: List[Optional[Cell]] = [None] * objcnt
    new_bounds: List[Optional[Cell]] = [None] * objcnt
    new_limit: List[Optional[Cell]] = [None] * objcnt
    num_sub_clusters = min(n_obj_left, n_workers)
    index = n_obj_left - 1
    for _ in range(num_sub_clusters):
        pos = my_ordering[index]
        if sense is Sense.MIN:
            new_shares[pos] = Cell(INF)
            new_bounds[pos] = Cell(-INF)
            new_limit[pos] = Cell(INF)
        else:
            new_shares[pos] = Cell(-INF)
            new_bounds[pos] = Cell(INF)
            new_limit[pos] = Cell(-INF)
        index = (index + 1) % n_obj_left

    def recurse_child(n_child: int) -> None:
        """One child sub-cluster at my_ordering[n_obj_left-1] (the shared
        position), then rotate the ordering (cluster.cpp:82-158)."""
        pos = my_ordering[n_obj_left - 1]
        locks[pos] = LockGroup()
        old_to = share_to[pos]
        old_bounds = share_bounds[pos]
        old_limit = share_limit[pos]
        old_from = {my_ordering[j]: share_from[my_ordering[j]] for j in range(n_obj_left)}
        for j in range(n_obj_left):
            obj = my_ordering[j]
            if obj == pos:
                share_to[obj] = new_shares[obj]
                share_bounds[obj] = new_bounds[obj]
                share_limit[obj] = new_limit[obj]
            else:
                share_from[obj] = new_shares[obj]
        _cluster(
            n_child,
            objcnt,
            sense,
            spread,
            n_obj_left - 1,
            my_ordering,
            share_to,
            share_from,
            share_bounds,
            share_limit,
            specs,
            locks,
        )
        share_to[pos] = old_to
        share_bounds[pos] = old_bounds
        share_limit[pos] = old_limit
        for j in range(n_obj_left):
            obj = my_ordering[j]
            share_from[obj] = old_from[obj]
        # rotate the first n_obj_left entries left by one (cluster.cpp:112-117)
        my_ordering[:n_obj_left] = (
            my_ordering[1:n_obj_left] + my_ordering[:1]
        )
        locks[pos] = None

    if spread:
        per_cluster = n_workers // n_obj_left
        with_extra = n_workers % n_obj_left
        for _ in range(with_extra):
            recurse_child(per_cluster + 1)
        if per_cluster > 0:
            for _ in range(n_obj_left - with_extra):
                recurse_child(per_cluster)
    else:
        remaining = n_workers
        while remaining > 0:
            use = min(factorial(n_obj_left - 1), remaining)
            recurse_child(use)
            remaining -= use

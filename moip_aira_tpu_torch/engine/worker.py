"""The AIRA recursive search loop, as a cooperative state machine.

Reference parity: ``optimise<Sense>`` in src/aira.cpp:538-1884.  The control
flow (objective_counter / depth / infcnt / inflast / onwalk state machine,
the relaxation-store lookups, the bound-sharing protocol and the EPP strip
checks) is transcribed faithfully; what changes is the execution model:

* The reference runs one OS thread per worker, each owning a private CPLEX
  environment, and blocks inside ``CPXmipopt``.  Here a worker is a Python
  generator that *yields* each CLMOIP subproblem (an objective-bound vector)
  and receives the solved objective vector back.  The scheduler collects the
  yields of all live workers and solves them as one batched, jitted TPU call
  per round (engine/scheduler.py), which is how the sequential-per-worker
  algorithm extracts data parallelism on a chip.
* The reference's mutex/condvar bound exchange (aira.cpp:923-1574) is
  vestigial — ``Locking_Vars::add_state`` is never called, so every thread
  always takes the non-blocking branch (SURVEY §2/C8).  The cooperative
  scheduler makes the same reads/writes of the shared cells at the same
  program points, deterministically.

Sense handling: the reference instantiates ``optimise<MIN>`` /
``optimise<MAX>`` templates; here the MIN/MAX asymmetry is folded into a few
sign helpers (``fwd`` = the direction bounds are tightened: -1 for MIN since
RHS walks downward, +1 for MAX).
"""

from __future__ import annotations

from typing import Generator, List, Optional, Tuple

import numpy as np

from moip_aira_tpu_torch.core.store import Solutions
from moip_aira_tpu_torch.engine.worker_spec import WorkerSpec
from moip_aira_tpu_torch.problem import Problem
from moip_aira_tpu_torch.sense import INF, Sense
from moip_aira_tpu_torch.utils.trace import GLOBAL_TIMINGS

# What a worker yields: the objective-bound vector of the CLMOIP it needs
# solved. What it receives back: (infeasible, result_ints_or_None).
SolveYield = np.ndarray
SolveReply = Tuple[bool, Optional[np.ndarray]]


def aira_worker(
    problem: Problem,
    t: WorkerSpec,
    all_store: Solutions,
    infeasibles: Solutions,
) -> Generator[SolveYield, SolveReply, None]:
    """Enumerate (a share of) the nondominated set for one worker.

    Mirrors optimise<Sense> (aira.cpp:538-1884). Feasible results are
    inserted into a worker-local store (synergistic mode) that is merged
    into ``all_store`` on completion, or directly into ``all_store`` (EPP
    mode), exactly as the reference does (aira.cpp:842-850, 1877-1879).
    """
    sense = problem.objsen
    is_min = sense is Sense.MIN
    k = problem.objcnt
    perm = t.perm
    sharing = t.sharing
    split = t.split

    # local store: EPP workers write straight to the global store (same
    # concrete store type as the global one so merge() is homogeneous)
    s = all_store if split else type(all_store)(k)

    inf_here = INF if is_min else -INF  # "unconstrained" RHS value
    step = -1.0 if is_min else 1.0  # direction RHS bounds are tightened

    def better_eq(a: float, b: float) -> bool:
        # "a is at least as tight a solution bound as b" in this sense
        return a >= b if is_min else a <= b

    rhs = problem.initial_rhs()
    if split:
        rhs[perm[t.nobj - 1]] = t.split_start

    # --- first (unconstrained) solve: aira.cpp:614-651 --------------------
    result = yield rhs.copy()
    infeasible, res = result
    if infeasible:
        infeasibles.insert(rhs, None, True)
        # whole problem (or whole strip) infeasible — nothing to enumerate
        return
    s.insert(rhs, res, False)

    if split:
        t.split_stop += step  # widen strip by one unit (aira.cpp:75-79)

    # share the "first bound" with the partner (aira.cpp:679-692)
    if sharing and k > 1:
        i = perm[1]
        cell = t.share_to[i]
        if cell is not None:
            if is_min:
                if cell.value < res[i]:
                    cell.value = float(res[i])
            else:
                if cell.value > res[i]:
                    cell.value = float(res[i])

    max_ = np.array([float(v) for v in res])
    min_ = max_.copy()

    # --- main nest: aira.cpp:700-1840 --------------------------------------
    for objective_counter in range(1, t.nobj):
        objective = perm[objective_counter]
        depth_level = 1
        depth = perm[depth_level]
        onwalk = False
        infcnt = 0
        inflast = False

        # reset all bound rows to +-inf / shared values (aira.cpp:733-756)
        for j_pre in range(1, k):
            j = perm[j_pre]
            cell = t.share_from[j] if sharing else None
            rhs[j] = inf_here if cell is None else cell.value
        if split:
            rhs[perm[t.nobj - 1]] = t.split_start
        # step the outer objective past the tightest value seen so far
        if is_min:
            rhs[objective] = max_[objective] - 1
        else:
            rhs[objective] = min_[objective] + 1
        if split:
            last = t.nobj - 1
            if (is_min and rhs[last] < t.split_stop) or (
                not is_min and rhs[last] > t.split_stop
            ):
                break
        max_[objective] = -INF
        min_[objective] = INF

        while infcnt < objective_counter:
            # -- relaxation lookup (aira.cpp:816-827) -----------------------
            relax = infeasibles.find(rhs, sense)
            if relax is None:
                relax = s.find(rhs, sense)
            GLOBAL_TIMINGS.count("store.lookup")
            if relax is not None:
                GLOBAL_TIMINGS.count("store.hit")
                infeasible = relax.infeasible
                res = relax.result
            else:
                infeasible, res = yield rhs.copy()
                if infeasible:
                    infeasibles.insert(rhs, None, True)
                else:
                    s.insert(rhs, res, False)

            # -- accounting: split / locked-sharing / plain -----------------
            if split:
                # aira.cpp: strip-boundary check + max/min update
                if not infeasible:
                    if infcnt == t.nobj - 2:
                        last = t.nobj - 1
                        if (is_min and rhs[last] < t.split_stop) or (
                            not is_min and rhs[last] > t.split_stop
                        ):
                            infeasible = True
                    np.maximum(max_, res, out=max_)
                    np.minimum(min_, res, out=min_)
                if infeasible:
                    infcnt += 1
                    inflast = True
                else:
                    infcnt = 0
                    inflast = False
            elif sharing and t.locks[perm[infcnt + 1]] is not None:
                # Locked partner exchange — a statement-level transcription
                # of aira.cpp:923-1107 (the whole block runs under
                # locks[perm(infcnt+1)]->status_mutex there; here the
                # bulk-synchronous scheduler serialises workers, so the
                # cells need no mutex).  Oddities below are the REFERENCE'S
                # semantics, kept for front/ipcount parity — each sub-block
                # cites its source lines.
                #
                # (1) publish this result's perm[1] value to the partner
                #     ("faster update" comment, aira.cpp:932-945)
                if not infeasible and k > 1:
                    cell = t.share_to[perm[1]]
                    if cell is not None:
                        cell.value = float(res[perm[1]])
                # (2) bail-out check (aira.cpp:946-1027): if the partner's
                #     published first bound already covers our perm[0] value,
                #     pretend infeasible to backtrack; if the partner also
                #     found_any, reset to a depth-1 walk (aira.cpp:975-981).
                first_cell = t.share_from[perm[0]]
                if not infeasible and first_cell is not None:
                    covered = (
                        res[perm[0]] >= first_cell.value
                        if is_min
                        else res[perm[0]] <= first_cell.value
                    )
                    if covered:
                        # note: infcnt may be reset to 0 HERE; later reads
                        # of locks[perm[infcnt+1]] intentionally use the
                        # new value, exactly as the reference re-evaluates
                        # t->perm(infcnt+1) at aira.cpp:1030/1060
                        lv = t.locks[perm[infcnt + 1]]
                        if lv is not None and lv.found_any:
                            infcnt = 0
                            inflast = True
                            depth_level = 1
                            depth = perm[depth_level]
                        infeasible = True
                    # max/min update runs even on the covered path — the
                    # reference's own "Duplicate code as we are marking
                    # this result infeasible" block (aira.cpp:1015-1027)
                    np.maximum(max_, res, out=max_)
                    np.minimum(min_, res, out=min_)
                # (3) feasible: raise found_any for the partner and update
                #     max/min AGAIN (aira.cpp:1028-1057 repeats the update;
                #     harmless — max/min are idempotent monotone folds)
                if not infeasible:
                    lv = t.locks[perm[infcnt + 1]]
                    if lv is not None:
                        lv.found_any = True
                    infcnt = 0
                    inflast = False
                    np.maximum(max_, res, out=max_)
                    np.minimum(min_, res, out=min_)
                # (4) infeasible epilogue (aira.cpp:1058-1082): a partner
                #     find resets the infeasibility streak before counting
                #     this one; perm[infcnt+1] again reflects any reset
                #     from (2), as in the reference
                if infeasible:
                    lv = t.locks[perm[infcnt + 1]]
                    if lv is not None and lv.found_any:
                        infcnt = 0
                    infcnt += 1
                    inflast = True
                else:
                    infcnt = 0
                    inflast = False
            else:
                # plain accounting (aira.cpp:1566-1574 region)
                if infeasible:
                    infcnt += 1
                    inflast = True
                else:
                    infcnt = 0
                    inflast = False
                    np.maximum(max_, res, out=max_)
                    np.minimum(min_, res, out=min_)

            # -- cluster bound-sync rounds (aira.cpp:1111-1551) -------------
            if sharing and infeasible and (infcnt + 1) < k:
                _cluster_sync(t, k, is_min, infcnt, max_, min_)

            # -- pre-exit share of the last objective (aira.cpp:1553-1563) --
            if (
                sharing
                and k > 2
                and infcnt == objective_counter
                and infcnt == k - 2
            ):
                cell = t.share_to[perm[k - 1]]
                if cell is None:
                    continue  # loop condition now false -> exit
                cell.value = float(
                    max_[perm[k - 1]] if is_min else min_[perm[k - 1]]
                )

            # -- rhs state machine (aira.cpp:1575-1832) ---------------------
            if infeasible and infcnt == objective_counter - 1:
                # full dead-end: reset and advance the outer objective
                if sharing and k > 2 and objective_counter == k - 1:
                    if t.share_to[perm[k - 1]] is not None:
                        cell = t.share_to[objective]
                        if cell is not None:
                            cell.value = float(
                                max_[objective] if is_min else min_[objective]
                            )
                for pre_j in range(k):
                    j = perm[pre_j]
                    limit_c = t.share_limit[j] if sharing else None
                    from_c = t.share_from[j] if sharing else None
                    if pre_j < infcnt or (limit_c is None and from_c is None):
                        rhs[j] = inf_here
                    else:
                        src = limit_c if limit_c is not None else from_c
                        rhs[j] = src.value + step
                        to_c = t.share_to[j]
                        if to_c is not None:
                            if is_min:
                                if to_c.value > src.value:
                                    to_c.value = src.value
                            else:
                                if to_c.value < src.value:
                                    to_c.value = src.value
                if split:
                    rhs[t.nobj - 1] = t.split_start
                if is_min:
                    rhs[objective] = max_[objective] - 1
                    max_[objective] = -INF
                else:
                    rhs[objective] = min_[objective] + 1
                    min_[objective] = INF
                depth_level = 1
                depth = perm[depth_level]
                onwalk = False
            elif inflast and infcnt != objective_counter:
                # walk one level deeper (aira.cpp:1679-1782)
                src = None
                if sharing:
                    if t.share_limit[depth] is not None:
                        src = t.share_limit[depth]
                    elif t.share_from[depth] is not None:
                        src = t.share_from[depth]
                rhs[depth] = inf_here if src is None else src.value + step
                depth_level += 1
                depth = perm[depth_level]
                limit_c = t.share_limit[depth] if sharing else None
                if is_min:
                    if limit_c is not None and (
                        limit_c.value < max_[depth] or max_[depth] == -INF
                    ):
                        rhs[depth] = limit_c.value - 1
                    else:
                        rhs[depth] = max_[depth] - 1
                    max_[depth] = -INF
                else:
                    if limit_c is not None and (
                        limit_c.value > min_[depth] or min_[depth] == INF
                    ):
                        rhs[depth] = limit_c.value + 1
                    else:
                        rhs[depth] = min_[depth] + 1
                    min_[depth] = INF
                onwalk = True
            elif not onwalk and infcnt != 1:
                # tighten at the current depth (aira.cpp:1783-1807)
                if is_min:
                    rhs[depth] = max_[depth] - 1
                    max_[depth] = -INF
                else:
                    rhs[depth] = min_[depth] + 1
                    min_[depth] = INF
            elif onwalk and infcnt != 1:
                # return to depth 1 (aira.cpp:1808-1832)
                depth_level = 1
                depth = perm[depth_level]
                if is_min:
                    rhs[depth] = max_[depth] - 1
                    max_[depth] = -INF
                else:
                    rhs[depth] = min_[depth] + 1
                    min_[depth] = INF
                onwalk = False

    # --- completion: merge local store into the global one -----------------
    if not split:
        all_store.merge(s)


def _cluster_sync(
    t: WorkerSpec,
    k: int,
    is_min: bool,
    infcnt: int,
    max_: np.ndarray,
    min_: np.ndarray,
) -> None:
    """The dead-end bound-exchange rounds (aira.cpp:1111-1551).

    Only the non-blocking "last thread in" legs are implemented: the
    reference's condvar waits never fire (Locking_Vars::add_state is dead
    code, so all_done() is vacuously true — SURVEY §2/C8) and the scheduler
    here is single-threaded by construction.  The protocol intent is:
    publish local max/min into the cluster's shared bound cells (monotone
    min/max reduction), adopt the reduced values, reset the per-level
    sharing cells, then propagate limits to a fixpoint via the `changed`
    flag.
    """
    perm = t.perm
    updated_objective = perm[infcnt + 1]
    lv = t.locks[updated_objective]
    if lv is None:
        return

    # publish + adopt share_bounds (two-way sync), aira.cpp:1293-1344 leg
    for pre_i in range(k):
        i = perm[pre_i]
        cell = t.share_bounds[i]
        if cell is None:
            continue
        if is_min:
            if cell.value < max_[i]:
                cell.value = float(max_[i])
            else:
                max_[i] = cell.value
        else:
            if cell.value > min_[i]:
                cell.value = float(min_[i])
            else:
                min_[i] = cell.value
    to_c = t.share_to[updated_objective]
    if to_c is not None:
        if is_min:
            if max_[updated_objective] != -INF:
                to_c.value = float(max_[updated_objective])
        else:
            if min_[updated_objective] != INF:
                to_c.value = float(min_[updated_objective])
    lv.found_any = False
    limit_c = t.share_limit[updated_objective]
    from_c = t.share_from[updated_objective]
    if limit_c is not None and from_c is not None:
        limit_c.value = from_c.value

    # reset cells for levels <= infcnt (aira.cpp:1352-1378)
    for i in range(infcnt + 1):
        j = perm[i]
        if is_min:
            max_[j] = -INF
            if t.share_to[j] is not None:
                t.share_to[j].value = INF
            if t.share_limit[j] is not None:
                t.share_limit[j].value = INF
        else:
            min_[j] = INF
            if t.share_to[j] is not None:
                t.share_to[j].value = -INF
            if t.share_limit[j] is not None:
                t.share_limit[j].value = -INF

    # barrier leg: reset share_bounds up to infcnt+1 (aira.cpp:1381-1404)
    for pre_i in range(min(infcnt + 2, k)):
        i = perm[pre_i]
        if t.share_bounds[i] is not None:
            t.share_bounds[i].value = -INF if is_min else INF

    # fixpoint propagation on `changed` (aira.cpp:1407-1512)
    while True:
        lv.changed = False
        for i in range(infcnt + 1):
            obj = perm[i]
            from_c = t.share_from[obj]
            if from_c is None:
                continue
            limit_c = t.share_limit[obj]
            to_c = t.share_to[obj]
            if is_min:
                if limit_c is not None and limit_c.value > from_c.value:
                    lv.changed = True
                    limit_c.value = from_c.value
                if to_c is not None and to_c.value > from_c.value:
                    lv.changed = True
                    to_c.value = from_c.value
            else:
                if limit_c is not None and limit_c.value < from_c.value:
                    lv.changed = True
                    limit_c.value = from_c.value
                if to_c is not None and to_c.value < from_c.value:
                    lv.changed = True
                    to_c.value = from_c.value
        if not lv.changed:
            break

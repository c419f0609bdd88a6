"""EPP — Efficient Projection Parallelisation ("--split").

Reference parity: src/aira.cpp:1886-1990 (`split_setup`, `split_optimise`)
plus the `normal_values` quantile table (aira.cpp:55-69).

``split_setup(nObj)`` recursively solves the (nObj-1)-objective problem to
measure the attainable range of objective nObj-1, then ``split_optimise``
partitions that range into one contiguous strip per worker — uniformly, or by
the precomputed Gaussian-quantile table when ``--split-normal`` — and runs a
full AIRA enumeration per strip.  Every recursion level is one scheduler run,
i.e. one wave of batched device solves.
"""

from __future__ import annotations

from typing import List

import numpy as np

from moip_aira_tpu_torch.core.store import Solutions
from moip_aira_tpu_torch.engine.scheduler import Scheduler
from moip_aira_tpu_torch.engine.worker_spec import WorkerSpec
from moip_aira_tpu_torch.sense import INF, Sense
from moip_aira_tpu_torch.solver.lex import LexRequest

# Gaussian strip-boundary quantiles, indexed [n_workers][i] — behavioural
# data reproduced from the reference (aira.cpp:55-69): worker i of X covers
# [row[i], row[i+1]] of the objective range under the assumption the values
# are N((hi+lo)/2, (hi-lo)/6)-distributed.  Only rows up to 12 workers exist.
NORMAL_VALUES = [
    [0.0],
    [0.0, 1.0],
    [0.0, 0.5, 1.0],
    [0.0, 0.356, 0.644, 1.0],
    [0.0, 0.275, 0.5, 0.725, 1.0],
    [0.0, 0.219, 0.416, 0.584, 0.781, 1.0],
    [0.0, 0.178, 0.256, 0.5, 0.644, 0.822, 1.0],
    [0.0, 0.144, 0.311, 0.44, 0.56, 0.689, 0.856, 1.0],
    [0.0, 0.117, 0.275, 0.394, 0.5, 0.606, 0.725, 0.883, 1.0],
    [0.0, 0.093, 0.245, 0.356, 0.453, 0.547, 0.644, 0.755, 0.907, 1.0],
    [0.0, 0.073, 0.219, 0.325, 0.416, 0.5, 0.584, 0.675, 0.781, 0.927, 1.0],
    [0.0, 0.055, 0.197, 0.298, 0.384, 0.462, 0.538, 0.616, 0.702, 0.803, 0.945, 1.0],
    [0.0, 0.039, 0.178, 0.275, 0.356, 0.430, 0.5, 0.570, 0.644, 0.725, 0.822, 0.961, 1.0],
]

MAX_WORKERS_NORMAL_SPLIT = 12  # aira.cpp:75


def get_limit(scheduler: Scheduler, obj: int) -> tuple:
    """Single-objective optimum under unconstrained bounds.

    Reference aira.cpp:367-450 optimises only ``obj`` and evaluates the other
    objectives from whatever optimal vertex CPLEX returns; here the remaining
    objectives are lexicographically tie-broken (perm = [obj, others...]) so
    the emitted point is deterministic and guaranteed nondominated (see the
    divergence note in solver/lex.py).

    Returns (status, result-or-None).
    """
    p = scheduler.problem
    perm = [obj] + [j for j in range(p.objcnt) if j != obj]
    req = LexRequest(rhs=p.initial_rhs(), perm=perm)
    out = scheduler.backend.lex_solve_batch([req])[0]
    scheduler.ip_count += out.ip_solves
    return out.status, out.result


def build_strip_specs(
    problem,
    nobj: int,
    hi: float,
    lo: float,
    n_workers: int,
    split_normal: bool,
) -> List[WorkerSpec]:
    """One EPP strip spec per worker over [lo, hi] of objective nobj-1
    (reference aira.cpp:1886-1920); shared by the single-host split path
    and the mesh strip distribution (engine/mesh_scheduler.py)."""
    sense = problem.objsen
    if sense is Sense.MIN:
        start_point, stop_point = float(hi), float(lo)
    else:
        start_point, stop_point = float(lo), float(hi)

    specs: List[WorkerSpec] = []
    if split_normal:
        row = NORMAL_VALUES[n_workers]
        for t in range(n_workers):
            if sense is Sense.MIN:
                gap = start_point - stop_point
                stop = row[t] * gap + stop_point
                start = row[t + 1] * gap + stop_point
            else:
                gap = stop_point - start_point
                start = row[t] * gap + start_point
                stop = row[t + 1] * gap + start_point
            specs.append(
                WorkerSpec.for_split(t, nobj, problem.objcnt, start, stop)
            )
    else:
        step = (stop_point - start_point) / n_workers
        s0 = start_point
        for t in range(n_workers):
            specs.append(
                WorkerSpec.for_split(t, nobj, problem.objcnt, s0, s0 + step)
            )
            s0 += step
    return specs


def split_optimise(
    scheduler: Scheduler,
    nobj: int,
    hi: float,
    lo: float,
    n_workers: int,
    split_normal: bool,
    infeasibles: Solutions,
) -> List[np.ndarray]:
    """Partition [lo, hi] of objective nobj-1 into strips and enumerate each
    (reference aira.cpp:1886-1943)."""
    p = scheduler.problem
    specs = build_strip_specs(p, nobj, hi, lo, n_workers, split_normal)

    from moip_aira_tpu_torch.native import make_solutions

    here = make_solutions(p.objcnt)
    scheduler.run(specs, here, infeasibles)
    return [row.copy() for row in here.feasible_points()]


def split_setup(
    scheduler: Scheduler,
    nobj: int,
    n_workers: int,
    split_normal: bool,
    infeasibles: Solutions,
) -> List[np.ndarray]:
    """Recursive range measurement + strip enumeration (aira.cpp:1945-1990).

    Returns the feasible points found at the top recursion level (the full
    ``nobj``-objective enumeration); lower levels only supply range bounds.
    """
    p = scheduler.problem
    if nobj == 1:
        status, res = get_limit(scheduler, 0)
        return [] if res is None else [np.asarray(res)]

    sols = split_setup(scheduler, nobj - 1, n_workers, split_normal, infeasibles)
    status, res = get_limit(scheduler, nobj - 1)
    if res is None:
        return []
    if p.objsen is Sense.MIN:
        smallest = float(res[nobj - 1])
        biggest = -INF
        for sol in sols:
            biggest = max(biggest, float(sol[nobj - 1]))
        if biggest == smallest:
            biggest = INF
    else:
        biggest = float(res[nobj - 1])
        smallest = INF
        for sol in sols:
            smallest = min(smallest, float(sol[nobj - 1]))
        if biggest == smallest:
            smallest = -INF
    return split_optimise(
        scheduler, nobj, biggest, smallest, n_workers, split_normal, infeasibles
    )

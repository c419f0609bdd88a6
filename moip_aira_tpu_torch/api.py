"""High-level front computation — the port of ``moip_aira_tpu/api.py``.

Same routing and the same drivers (the bound sweep for k=2, the AIRA
scheduler otherwise), with the device LPs of the wave backend on the
``device`` given.  What the port does not have yet raises
NotImplementedError instead of running something else: the ``jax``
backend, the knapsack front DP (``dp="on"``, kernel K4) and the mesh."""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np

from moip_aira_tpu.api import FrontResult as _RefFrontResult
from moip_aira_tpu.engine.scheduler import Scheduler
from moip_aira_tpu.native import make_solutions
from moip_aira_tpu.parallel.cluster import build_cluster
from moip_aira_tpu.parallel.split import MAX_WORKERS_NORMAL_SPLIT, split_setup
from moip_aira_tpu.parallel.symgroup import max_workers
from moip_aira_tpu.problem import Problem
from moip_aira_tpu.sense import INF, Sense

__all__ = ["FrontResult", "make_backend", "solve_front"]


@dataclasses.dataclass
class FrontResult(_RefFrontResult):
    #: counters of the backend that computed the front: the wave backend's
    #: device_waves, lp_count, verify_fallbacks and K1's kernel_launches
    backend_stats: Optional[dict] = None


def backend_stats(be) -> dict:
    """The counters a run reports for backend ``be``."""
    stats = {"backend": getattr(be, "name", type(be).__name__)}
    for key in ("device_waves", "lp_count", "verify_fallbacks"):
        if hasattr(be, key):
            stats[key] = int(getattr(be, key))
    kernel = getattr(be, "lp_kernel", None)
    if kernel is not None:
        stats["kernel_launches"] = int(kernel.launches)
    return stats


def make_backend(
    problem: Problem,
    backend="auto",
    device="cuda",
    mesh_devices=None,
    solver_threads: int = 1,
):
    """Build the lex backend named by ``backend`` (or return ``backend``
    itself when it is already a backend object).

    ``solver_threads`` mirrors the reference's `-c` knob: it scales the
    number of branch-and-bound nodes each MIP contributes to a device wave.
    ``auto`` routes the knapsack family to kp_bb, the assignment family to
    ap_bb, and everything else to the wave backend on ``device``."""
    if not isinstance(backend, str):
        return backend
    if mesh_devices:
        raise NotImplementedError(
            "mesh_devices: the multi-device mesh is not ported yet "
            "(ROADMAP.md, queue 1, item 8)"
        )
    npt = max(8, 8 * max(1, solver_threads))
    if backend == "numpy":
        from moip_aira_tpu.solver.lex import NumpyLexBackend

        return NumpyLexBackend(problem)
    if backend == "wave":
        from moip_aira_tpu_torch.solver.wave import WaveLexBackend

        return WaveLexBackend(problem, nodes_per_task=npt, device=device)
    if backend == "jax":
        raise NotImplementedError(
            "backend 'jax': the monolithic device backend (lex_jax) is not "
            "ported yet (ROADMAP.md, queue 1, item 7)"
        )
    if backend == "kpbb":
        from moip_aira_tpu.solver.kp_bb import KnapsackLexBackend

        return KnapsackLexBackend(problem)
    if backend == "apbb":
        from moip_aira_tpu.solver.ap_bb import APLexBackend

        return APLexBackend(problem)
    if backend == "auto":
        from moip_aira_tpu.solver.kp_bb import KnapsackLexBackend, detect_kp_family

        fam = detect_kp_family(problem)
        if fam is not None:
            return KnapsackLexBackend(problem, fam)
        from moip_aira_tpu.solver.ap_bb import APLexBackend, detect_ap_family

        afam = detect_ap_family(problem)
        if afam is not None:
            return APLexBackend(problem, afam)
        from moip_aira_tpu_torch.solver.wave import WaveLexBackend

        return WaveLexBackend(problem, nodes_per_task=npt, device=device)
    raise ValueError(f"unknown backend {backend!r}")


def solve_front(
    problem: Problem,
    n_workers: int = 1,
    spread: bool = True,
    split: bool = False,
    split_normal: bool = False,
    backend="auto",
    device="cuda",
    mesh_devices=None,
    solver_threads: int = 1,
    dp: str = "auto",
    sweep: str = "auto",
) -> FrontResult:
    """Compute the exact nondominated set of ``problem``.

    Mirrors the reference driver: the synergistic cluster decomposition by
    default, or the EPP range split with ``split=True``.  ``dp``: the
    knapsack front DP is not ported yet, so ``"auto"`` and ``"off"`` take
    the AIRA engine (whose front is the same) and ``"on"`` raises.
    ``sweep``: the adaptive bound sweep for bi-objective problems on the
    wave backend ('auto'), forced ('on') or never ('off'); MOIP_SWEEP
    overrides 'auto'."""
    t_cpu0 = time.process_time()
    t_wall0 = time.monotonic()
    n_workers = max(1, n_workers)

    if split and split_normal and n_workers > MAX_WORKERS_NORMAL_SPLIT:
        raise ValueError(
            f"split_normal supports at most {MAX_WORKERS_NORMAL_SPLIT} workers"
        )
    if dp == "on":
        raise NotImplementedError(
            "dp='on': the knapsack front DP and its kernel K4 are not ported "
            "yet (ROADMAP.md, queue 2, K4)"
        )

    be = make_backend(
        problem, backend, device=device, mesh_devices=mesh_devices,
        solver_threads=solver_threads,
    )

    if sweep == "auto":
        sweep = os.environ.get("MOIP_SWEEP", "auto")
    use_sweep = (
        sweep != "off"
        and problem.objcnt == 2
        and not split
        and getattr(be, "name", "") == "wave"
    ) or sweep == "on"
    if use_sweep:
        from moip_aira_tpu.solver.sweep import sweep_front

        sw = sweep_front(problem, be, batch=getattr(be, "batch_width", 64))
        if sw is not None:
            return FrontResult(
                points=sw.points,
                ip_count=sw.ip_count,
                cpu_seconds=time.process_time() - t_cpu0,
                elapsed_seconds=time.monotonic() - t_wall0,
                rounds=sw.rounds,
                batch_sizes=sw.batch_sizes,
                backend_stats=backend_stats(be),
            )

    sched = Scheduler(problem, be)
    k = problem.objcnt
    all_store = make_solutions(k)
    infeasibles = make_solutions(k)
    if split:
        pts = split_setup(sched, k, n_workers, split_normal, infeasibles)
        # seed ip such that it can never answer a relaxation query
        dead_ip = np.full(k, -INF if problem.objsen is Sense.MIN else INF)
        for p_ in pts:
            all_store.insert(dead_ip, p_, False)
    else:
        n_workers = min(n_workers, max_workers(k))
        specs = build_cluster(n_workers, k, problem.objsen, spread)
        sched.run(specs, all_store, infeasibles)

    points = all_store.sorted_unique_points()
    return FrontResult(
        points=points,
        ip_count=sched.ip_count,
        cpu_seconds=time.process_time() - t_cpu0,
        elapsed_seconds=time.monotonic() - t_wall0,
        rounds=sched.rounds,
        batch_sizes=sched.batch_sizes,
        backend_stats=backend_stats(be),
    )

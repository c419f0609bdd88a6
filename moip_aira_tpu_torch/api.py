"""High-level front computation — the port of ``moip_aira_tpu/api.py``.

Same routing and the same drivers (the knapsack front DP for
single-capacity bi-objective knapsacks, the bound sweep for k=2, the AIRA
scheduler otherwise), with the device work (the DP's kernel K4, the wave
backend's LPs) on the ``device`` given.  What the port does not have yet
raises NotImplementedError instead of running something else: the ``jax``
backend and the mesh."""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional

import numpy as np

from moip_aira_tpu_torch.engine.scheduler import Scheduler
from moip_aira_tpu_torch.native import make_solutions
from moip_aira_tpu_torch.parallel.cluster import build_cluster
from moip_aira_tpu_torch.parallel.split import MAX_WORKERS_NORMAL_SPLIT, split_setup
from moip_aira_tpu_torch.parallel.symgroup import max_workers
from moip_aira_tpu_torch.problem import Problem
from moip_aira_tpu_torch.sense import INF, Sense

__all__ = ["FrontResult", "make_backend", "solve_front"]

#: ``dp="auto"`` tries the knapsack front DP from this many variables on
DP_MIN_VARS = 80


@dataclasses.dataclass
class FrontResult:
    #: nondominated points, sorted descending, deduplicated — shape (f, k)
    points: np.ndarray
    ip_count: int
    cpu_seconds: float
    elapsed_seconds: float
    rounds: int = 0
    batch_sizes: Optional[List[int]] = None
    #: counters of the backend that computed the front: the wave backend's
    #: device_waves, lp_count, verify_fallbacks, the name and
    #: kernel_launches of the kernel that served its device waves (the LP
    #: kernel, or K3 on the fragment path, which adds its frag_stats; K1
    #: adds its launches by plan shape, ``plan_shapes``, and as [shape, C,
    #: lanes, launches] rows, ``launch_lanes``); for
    #: the knapsack front DP, backend "kp_front", kernel "kp_dp" (K4) with
    #: its launches, the expanded items, the table cells and the engine
    backend_stats: Optional[dict] = None

    @property
    def solution_count(self) -> int:
        return int(self.points.shape[0])


def backend_stats(be) -> dict:
    """The counters a run reports for backend ``be``."""
    stats = {"backend": getattr(be, "name", type(be).__name__)}
    for key in ("device_waves", "lp_count", "verify_fallbacks"):
        if hasattr(be, key):
            stats[key] = int(getattr(be, key))
    kernel = getattr(be, "lp_kernel", None)
    if getattr(be, "fragments", False):
        kernel = be.frag_kernel
        fs = be.frag_stats
        stats["fragments"] = {
            k: fs[k] for k in ("records", "host_recs", "reopened", "waves", "ticks")
        }
    if kernel is not None:
        stats["kernel"] = kernel.kernel
        stats["kernel_launches"] = int(kernel.launches)
        if hasattr(kernel, "plan_shapes"):  # K1: its launches by plan shape
            stats["plan_shapes"] = dict(kernel.plan_shapes)
            stats["launch_lanes"] = sorted(
                [shape, C, lanes, k] for (shape, C, lanes), k in kernel.launch_lanes.items()
            )
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
    ap_bb, and everything else to the wave backend on ``device`` — an
    assignment instance whose objectives are too large for ap_bb's exact
    matching sums (``ap_bb.blend_safe``) included."""
    if not isinstance(backend, str):
        return backend
    if mesh_devices:
        raise NotImplementedError(
            "mesh_devices: the multi-device mesh is not ported yet "
            "(ROADMAP.md, queue 1, item 4)"
        )
    npt = max(8, 8 * max(1, solver_threads))
    if backend == "numpy":
        from moip_aira_tpu_torch.solver.lex import NumpyLexBackend

        return NumpyLexBackend(problem)
    if backend == "wave":
        from moip_aira_tpu_torch.solver.wave import WaveLexBackend

        return WaveLexBackend(problem, nodes_per_task=npt, device=device)
    if backend == "jax":
        raise NotImplementedError(
            "backend 'jax': the monolithic device backend (lex_jax) is not "
            "ported yet (ROADMAP.md, queue 1, item 3)"
        )
    if backend == "kpbb":
        from moip_aira_tpu_torch.solver.kp_bb import KnapsackLexBackend

        return KnapsackLexBackend(problem)
    if backend == "apbb":
        from moip_aira_tpu_torch.solver.ap_bb import APLexBackend

        return APLexBackend(problem)
    if backend == "auto":
        from moip_aira_tpu_torch.solver.kp_bb import KnapsackLexBackend, detect_kp_family

        fam = detect_kp_family(problem)
        if fam is not None:
            return KnapsackLexBackend(problem, fam)
        from moip_aira_tpu_torch.solver.ap_bb import APLexBackend, detect_ap_family

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
    default, or the EPP range split with ``split=True``.

    ``dp``: 'auto' sends single-capacity bi-objective knapsack instances of
    n >= 80 variables to the full-front dynamic program
    (solver/kp_front.py: K4 on a CUDA ``device``, its plain version on the
    CPU), which returns the whole nondominated set with no MIP ladder
    (``ip_count`` 0); 'off' forces the general AIRA engine; 'on' tries the
    DP at any size, even when the ``MOIP_DP`` environment override (which
    'auto' reads; the test suite sets it to 'off' to pin the AIRA path)
    says otherwise.  A problem the DP does not detect takes the AIRA
    engine.  The front is identical either way (the DP is exact); the
    decomposition flags only affect how the AIRA engine would have
    parallelised, so they are validated but otherwise moot.
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
    if dp == "auto":
        dp = os.environ.get("MOIP_DP", "auto")
    # the reference's threshold: below n = 80 it measured the host engine
    # ahead of the DP's device round trip (moip_aira_tpu/api.py:171-176)
    if dp == "on" or (dp != "off" and problem.n >= DP_MIN_VARS):
        from moip_aira_tpu_torch.solver.kp_front import kp2_front

        stats: dict = {}
        pts = kp2_front(problem, engine="auto", device=device, stats=stats)
        if pts is not None:
            return FrontResult(
                points=pts,
                ip_count=0,
                cpu_seconds=time.process_time() - t_cpu0,
                elapsed_seconds=time.monotonic() - t_wall0,
                backend_stats=stats,
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
        from moip_aira_tpu_torch.solver.sweep import sweep_front

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

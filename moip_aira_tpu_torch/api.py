"""High-level front computation — the port of ``moip_aira_tpu/api.py``.

Same routing and the same drivers (the knapsack front DP for
single-capacity bi-objective knapsacks, the bound sweep for k=2, the mesh
scheduler under ``mesh_devices``, the AIRA scheduler otherwise), with the
device work (the DP's kernel K4, the wave backend's LPs, the lex backend's
B&B) on the ``device`` given."""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional

import numpy as np
import torch

from moip_aira_tpu_torch.device import resolve_device
from moip_aira_tpu_torch.engine.scheduler import Scheduler
from moip_aira_tpu_torch.native import make_solutions
from moip_aira_tpu_torch.parallel.cluster import build_cluster
from moip_aira_tpu_torch.parallel.split import MAX_WORKERS_NORMAL_SPLIT, split_setup
from moip_aira_tpu_torch.parallel.symgroup import max_workers
from moip_aira_tpu_torch.problem import Problem
from moip_aira_tpu_torch.sense import INF, Sense

__all__ = ["FrontResult", "device_mesh", "make_backend", "solve_front"]

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
    #: its launches, the expanded items, the table cells and the engine;
    #: for the lex backend ("jax"), its batches, lanes, fallbacks and the
    #: steps of its B&B and LP loops with the host syncs they took; under a
    #: mesh also "mesh": its mode, shape and the mesh scheduler's
    #: exchanged_boxes, carried_boxes and severed
    backend_stats: Optional[dict] = None
    #: mesh runs only: per-domain IP counts + shared pre-work IPs — on real
    #: multi-device hardware wall time tracks pre_ips + max(domain_ips)
    domain_ips: Optional[List[int]] = None
    pre_ips: int = 0

    @property
    def solution_count(self) -> int:
        return int(self.points.shape[0])


def backend_stats(be) -> dict:
    """The counters a run reports for backend ``be``."""
    stats = {"backend": getattr(be, "name", type(be).__name__)}
    for key in (
        "device_waves", "lp_count", "verify_fallbacks",  # the wave
        "device_batches", "lanes", "fallback_count",  # the lex backend
        "bnb_steps", "lp_steps", "host_syncs",
    ):
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


def device_mesh(mesh_devices: int, device="cuda"):
    """The mesh of ``mesh_devices`` domains for work on ``device``: the
    visible cards for a CUDA device (one domain on a one-card machine), the
    CPU for the CPU."""
    from moip_aira_tpu_torch.parallel.mesh import make_mesh

    cpu = resolve_device(device).type == "cpu"
    return make_mesh(mesh_devices, devices=[torch.device("cpu")] if cpu else None)


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
    ap_bb, and everything else — an assignment instance whose objectives
    are too large for ap_bb's exact matching sums (``ap_bb.blend_safe``)
    included — to the lex backend ("jax") on the CPU and to the wave
    backend on a card, as the reference routes by platform.
    ``mesh_devices`` builds the wave's mesh (``device_mesh``)."""
    if not isinstance(backend, str):
        return backend
    npt = max(8, 8 * max(1, solver_threads))

    def wave():
        from moip_aira_tpu_torch.solver.wave import WaveLexBackend

        mesh = device_mesh(mesh_devices, device) if mesh_devices else None
        return WaveLexBackend(problem, nodes_per_task=npt, device=device, mesh=mesh)

    if backend == "numpy":
        from moip_aira_tpu_torch.solver.lex import NumpyLexBackend

        return NumpyLexBackend(problem)
    if backend == "wave":
        return wave()
    if backend == "jax":
        from moip_aira_tpu_torch.solver.lex_torch import TorchLexBackend

        return TorchLexBackend(problem, device=device)
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
        if resolve_device(device).type == "cpu":
            from moip_aira_tpu_torch.solver.lex_torch import TorchLexBackend

            return TorchLexBackend(problem, device=device)
        return wave()
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
    batch-parallel backends, wave and jax, without a mesh ('auto'), forced
    ('on') or never ('off'); MOIP_SWEEP overrides 'auto'.
    ``mesh_devices`` (without ``split``) runs the mesh scheduler over that
    many domains (``device_mesh``, or the backend's own mesh), in the mode
    ``MOIP_MESH_MODE`` names: ``strip`` (the default, EPP strips) or
    ``sync`` (synergistic workers, at most ``max_workers(k)``)."""
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
        and not mesh_devices
        and getattr(be, "name", "") in ("wave", "jax")
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

    if mesh_devices and not split:
        # distributed enumeration: workers partitioned into per-device
        # domains, cross-domain pruning through the mesh collective
        from moip_aira_tpu_torch.engine.mesh_scheduler import MeshScheduler

        mesh_mode = os.environ.get("MOIP_MESH_MODE", "strip")
        if mesh_mode == "sync":
            # synergistic workers cap at the ordering-subgroup count; EPP
            # strips (the default) have no such ceiling
            n_workers = min(n_workers, max_workers(k))
        msched = MeshScheduler(
            problem, be,
            getattr(be, "mesh", None) or device_mesh(mesh_devices, device),
            mode=mesh_mode,
        )
        msched.run(n_workers, spread, all_store)
        stats = backend_stats(be)
        stats["mesh"] = {
            "mode": mesh_mode,
            "shape": msched.mesh.shape,
            **{key: getattr(msched, key) for key in (
                "exchanged_boxes", "carried_boxes", "severed")},
        }
        return FrontResult(
            points=all_store.sorted_unique_points(),
            ip_count=msched.ip_count,
            cpu_seconds=time.process_time() - t_cpu0,
            elapsed_seconds=time.monotonic() - t_wall0,
            rounds=msched.rounds,
            batch_sizes=msched.batch_sizes,
            backend_stats=stats,
            domain_ips=list(msched.domain_ips),
            pre_ips=msched.pre_ips,
        )

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

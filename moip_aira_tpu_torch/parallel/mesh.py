"""Device meshes, sharded solve rounds and the bound-exchange collective —
the port of ``moip_aira_tpu/parallel/mesh.py``.

A single controller, as in the JAX package: one process owns every device
of the mesh.  The mesh is a (workers, strips) grid of ``torch.device``s, and
each grid cell is a *domain*.  A batch is split over the domains in
row-major order (the reference's ``PartitionSpec(("workers", "strips"))``),
and what the reference gathers with ``all_gather(tiled=True)`` over each
axis in turn comes back strips-major: the domain at (w, s) lands at
position ``s * W + w`` (``gather_order``).  Box order reaches the stores, so
the port keeps it.

Where the work runs: domains that share one device run as one batch and
reduce in one op; the results of domains on several cards are gathered onto
the first domain's card, where the min/max reductions run.  The wave
backend (solver/wave.py) spreads each wave's lanes over the same device
groups (``by_device``), in proportion to their domains (``lane_chunks``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from moip_aira_tpu_torch.problem import Problem

BIGVAL = float(2**52)

__all__ = [
    "BIGVAL", "Mesh", "by_device", "gather_order", "lane_chunks",
    "make_bound_exchange", "make_distributed_round", "make_mesh",
    "shard_batch", "visible_devices",
]


class Mesh:
    """A grid of devices with named axes (``jax.sharding.Mesh``'s fields
    that the JAX package reads: ``devices``, ``axis_names``, ``size`` and
    ``shape``)."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]):
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def domain_devices(self) -> List[torch.device]:
        """The device of each domain, in row-major (batch) order."""
        return list(self.devices.flat)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.domain_devices()]})"


def visible_devices() -> List[torch.device]:
    """The visible cards, ``cuda:0`` first, or the CPU where there is none."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_mesh(
    n_devices: Optional[int] = None,
    devices: Optional[Sequence] = None,
    axes: Tuple[str, str] = ("workers", "strips"),
) -> Mesh:
    """A 2D mesh over ``devices`` (default: ``visible_devices()``), cut to
    the first ``n_devices`` as the reference cuts ``jax.devices()``.

    The second axis gets the largest power-of-two factor <= sqrt(n), the
    first the rest — e.g. 8 devices -> (4, 2), 1 device -> (1, 1).  On a
    machine with one card, ``make_mesh(8)`` is one domain."""
    devs = [torch.device(d) for d in (visible_devices() if devices is None else devices)]
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    s = 1
    while s * 2 <= max(1, int(n**0.5)) and n % (s * 2) == 0:
        s *= 2
    w = n // s
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(w, s), axes)


def gather_order(mesh: Mesh) -> np.ndarray:
    """Domain indices in the order ``all_gather(tiled=True)`` over each mesh
    axis in turn concatenates them: strips-major."""
    return np.arange(mesh.size).reshape(mesh.devices.shape).T.ravel()


def shard_batch(mesh: Mesh, arr) -> List[torch.Tensor]:
    """Split a batch-leading array into one contiguous shard per domain, in
    row-major mesh order, each on its domain's device."""
    t = torch.as_tensor(arr)
    if t.shape[0] % mesh.size:
        raise ValueError(
            f"batch of {t.shape[0]} does not split over {mesh.size} domains"
        )
    return [
        s.to(d) for s, d in zip(torch.chunk(t, mesh.size), mesh.domain_devices())
    ]


def _gather(mesh: Mesh, shards: Sequence[torch.Tensor]) -> torch.Tensor:
    """Every domain's shard, in ``gather_order``, on the first domain's
    device."""
    first = mesh.domain_devices()[0]
    return torch.cat([shards[d].to(first) for d in gather_order(mesh)])


def by_device(mesh: Mesh) -> List[Tuple[torch.device, List[int]]]:
    """Domains grouped by device, the groups in the order of their first
    domain, each group in domain order."""
    groups: dict = {}
    for d, dev in enumerate(mesh.domain_devices()):
        groups.setdefault(dev, []).append(d)
    return list(groups.items())


def lane_chunks(lanes: int, weights: Sequence[int]) -> List[Tuple[int, int]]:
    """``lanes`` lanes split, in order, into one contiguous ``[start, end)``
    chunk per weight, each sized in proportion to its weight: chunk i ends
    at ceil(lanes * (w_0 + ... + w_i) / sum(w)), so each chunk is within one
    lane of its share, and the first chunks take what the shares leave over
    (a wave of fewer lanes than chunks fills the first ones)."""
    total = sum(weights)
    if total <= 0 or min(weights) <= 0:
        raise ValueError(f"weights must be positive, got {list(weights)}")
    edges, acc = [0], 0
    for w in weights:
        acc += w
        edges.append(-(-lanes * acc // total))
    return list(zip(edges[:-1], edges[1:]))


def _extremes(vals: torch.Tensor, valid: torch.Tensor):
    """Per-objective min and max over the valid rows, (1, k) each; BIGVAL
    and -BIGVAL where no row is valid."""
    v = vals.to(torch.float64)
    m = valid[:, None]
    lo = torch.where(m, v, BIGVAL).amin(0, keepdim=True)
    hi = torch.where(m, v, -BIGVAL).amax(0, keepdim=True)
    return lo, hi


def make_distributed_round(problem: Problem, mesh: Mesh, batch_per_device: int = 2):
    """One bulk-synchronous solve round over the mesh.

    Returns (step_fn, batch_size).  ``step_fn(rhs, perm)`` with rhs (B, k)
    f64 and perm (B, k) int, B = batch_per_device * mesh size:

      1. splits the subproblem batch over the domains,
      2. runs the lex kernel (solver/lex_torch.py) on every lane, the
         domains of one device as one batch on it (one launch of K6 on a
         card; a perm naming an objective outside [0, k) raises first,
         unless it is already on a card, where K6 marks its lanes
         ``LEX_BAD_PERM``),
      3. reduces per-objective bound vectors (min and max over the feasible
         lanes of every domain), and
      4. gathers every lane's result and status in ``gather_order``.

    It returns (status (B,) in batch order, all_results (B, k),
    all_status (B,), lo (1, k), hi (1, k)), the last four on the first
    domain's device."""
    from moip_aira_tpu_torch.solver.lex_torch import check_perm, make_lex_kernel

    groups = by_device(mesh)
    kernels = {dev: make_lex_kernel(problem, device=dev) for dev, _ in groups}
    B = batch_per_device * mesh.size

    def step(rhs, perm):
        check_perm(perm, problem.objcnt)
        rhs_s = shard_batch(mesh, torch.as_tensor(rhs, dtype=torch.float64))
        perm_s = shard_batch(mesh, torch.as_tensor(perm, dtype=torch.int64))
        st: List[torch.Tensor] = [None] * mesh.size
        res: List[torch.Tensor] = [None] * mesh.size
        for dev, doms in groups:
            s, r, _ips = kernels[dev](
                torch.cat([rhs_s[d] for d in doms]), torch.cat([perm_s[d] for d in doms])
            )
            for d, sd, rd in zip(doms, s.split(batch_per_device), r.split(batch_per_device)):
                st[d], res[d] = sd, rd
        first = mesh.domain_devices()[0]
        status = torch.cat([s.to(first) for s in st])
        all_results = _gather(mesh, res)
        all_status = _gather(mesh, st)
        lo, hi = _extremes(all_results, all_status == 0)
        return status, all_results, all_status, lo, hi

    return step, B


def make_bound_exchange(mesh: Mesh, k: int, slots: int):
    """The per-round enumeration collective: the gather of every domain's
    new infeasible boxes (permutation-independent facts every domain can
    prune with) and the min/max of the solved objective values (after the
    first round, the exact ideal point).

    Returns ``exchange(boxes, flags, vals, vflags)`` over (D*slots, ...)
    batches, domain d's rows at ``d*slots``:
      boxes  (D*slots, k) f64 — infeasible rhs boxes (padding rows arbitrary)
      flags  (D*slots,)  int — 1 = real box, 0 = padding
      vals   (D*slots, k) f64 — feasible result vectors
      vflags (D*slots,)  int — 1 = real value row, 0 = padding
    and gives (all_boxes, all_flags, lo (1, k), hi (1, k)) on the first
    domain's device, the boxes and flags in ``gather_order``."""
    del k, slots  # the shapes come with the arrays

    def exchange(boxes, flags, vals, vflags):
        all_boxes = _gather(mesh, shard_batch(mesh, boxes))
        all_flags = _gather(mesh, shard_batch(mesh, flags))
        vals_g = _gather(mesh, shard_batch(mesh, vals))
        vflags_g = _gather(mesh, shard_batch(mesh, vflags))
        lo, hi = _extremes(vals_g, vflags_g > 0)
        return all_boxes, all_flags, lo, hi

    return exchange

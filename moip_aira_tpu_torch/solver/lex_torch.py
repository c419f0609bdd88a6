"""Batched lexicographic branch and bound in PyTorch — the port of
``moip_aira_tpu/solver/lex_jax.py`` (the ``jax`` backend).

One call solves a batch of CLMOIP subproblems on one device: for each lane,
a loop over the objective permutation runs a depth-first branch and bound
(a fixed-capacity node stack) whose LP relaxations are the f64 dense simplex
of solver/simplex_dense.py on the unscaled system ``[A; C | -I]``.

The reference is one XLA program: a ``vmap`` of a ``lax.scan`` over stages
whose body is a ``lax.while_loop`` over B&B nodes, each node a
``lax.while_loop`` over pivots.  On a card the port's is one launch of K6
(csrc/lex_bnb.cu, through solver/cuda_lex.py): each lane's stages, B&B
nodes and LPs (K5's loop) in one kernel, with no host read.  On the CPU it
runs K6's plain version, the loop below, over the batch written out: each
stage runs its B&B loop until no lane's condition holds, and a lane whose
condition is false, or whose LP is done, is frozen (every update is masked
by it), so each lane computes what the reference's lane computes, alone or
in any batch.  Lanes that overflow the node stack or hit an iteration limit
report ``LEX_RESOURCE``, and ``TorchLexBackend`` re-solves them with the
exact NumPy backend, counting each one.
"""

from __future__ import annotations

from collections import Counter
from typing import List

import numpy as np
import torch

from moip_aira_tpu_torch.device import resolve_device
from moip_aira_tpu_torch.problem import Problem
from moip_aira_tpu_torch.sense import Sense
from moip_aira_tpu_torch.solver.cuda_lex import launch_lex_bnb
from moip_aira_tpu_torch.solver.lex import LexOutcome, LexRequest, NumpyLexBackend
from moip_aira_tpu_torch.solver.simplex_dense import PROGRESS_TOL, make_lp_solver
from moip_aira_tpu_torch.solver.simplex_np import COST_TOL, FEAS_TOL, PIVOT_TOL, STALL_LIMIT
from moip_aira_tpu_torch.solver.simplex_torch import ITER_LIMIT, OPTIMAL, UNBOUNDED
from moip_aira_tpu_torch.solver.status import SolveStatus
from moip_aira_tpu_torch.utils.trace import GLOBAL_TIMINGS, spanned

__all__ = [
    "LEX_BAD_PERM", "LEX_INFEASIBLE", "LEX_OPTIMAL", "LEX_RESOURCE", "LexKernel",
    "TorchLexBackend", "check_perm", "make_lex_kernel",
]

INT_TOL = 1e-6

# status codes for a lex solve lane
LEX_OPTIMAL = 0
LEX_INFEASIBLE = 1
LEX_RESOURCE = 3  # node stack overflow / iteration limit -> host fallback
# K6 only: a lane whose perm names an objective outside [0, k) runs no
# stage (the plain version raises before it runs)
LEX_BAD_PERM = 4


def check_perm(perm, k: int) -> None:
    """Raise ValueError unless every objective ``perm`` names lies in [0,
    k); a tensor on a card is left to K6, which reads it without a host
    wait and gives such a lane ``LEX_BAD_PERM``."""
    if torch.is_tensor(perm) and perm.is_cuda:
        return
    order = torch.as_tensor(perm)
    if order.numel() and not (0 <= int(order.min()) and int(order.max()) < k):
        raise ValueError(f"perm holds objectives outside [0, {k})")


def _ceil_tol(v):
    return torch.ceil(v - INT_TOL)


class LexKernel:
    """``fn(rhs (B, k) f64, perm (B, k) int) -> (status (B,) int32,
    results (B, k) int64, ips (B,) int32)``, tensors on ``device``: on a
    CUDA device one launch of K6 and no host read, on the CPU its plain
    version.  On the card a lane whose perm (a tensor already there) names
    an objective outside [0, k) gets ``LEX_BAD_PERM``; elsewhere such a
    perm raises ValueError.

    Counters: ``launches`` (K6's) and ``plan_launches`` (them by the plan's
    (shape, C, P)); ``lane_nodes`` and ``lane_iters``, each lane's B&B nodes
    and LP steps over all its stages in the last call (on its device; K6 is
    held to the plain version's lane by lane), ``nodes`` and ``iters``
    their sums over the calls, ``path_nodes`` and ``path_iters`` the
    largest lane's of each call, summed (the critical path); ``host_syncs``,
    the host reading a loop condition (0 on the card, where the caller's
    copy of the results is the one wait).  On the card the per-lane counts
    of a call are read once it has finished (without waiting, at the next
    call) or when a counter is read.  Only the plain loop has the lockstep
    counters ``bnb_steps`` (steps of the B&B loops, one node of every
    running lane) and ``lp_steps`` (steps of the LP loops, one pivot of
    every running lane), and ``lane_pivots``, each lane's pivots over the
    last call; on the card they are no attributes."""

    def __init__(
        self,
        problem: Problem,
        max_nodes_stack: int = 160,
        max_bnb_nodes: int = 20000,
        lp_max_iters: int = 2000,
        device="cuda",
    ):
        p = problem
        dev = resolve_device(device)
        f64 = torch.float64
        self.device = dev
        self.k, self.n, self.m = p.objcnt, p.n, p.m_total
        self.is_min = p.objsen is Sense.MIN
        self.maxn = max_nodes_stack
        self.max_bnb_nodes = max_bnb_nodes
        A_full = np.vstack([p.A, p.C])
        #: the LPs' system [A; C | -I], on the device
        self.W = torch.as_tensor(np.hstack([A_full, -np.eye(self.m)]), dtype=f64, device=dev)
        self.lp_max_iters = lp_max_iters
        #: the plain loop's LP solver (the CPU only; K6 runs K5's loop with
        #: the same defaults)
        self.lp = None if dev.type == "cuda" else make_lp_solver(self.W, lp_max_iters)

        def t(a, dtype=f64):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        self.C = t(p.C)
        self.lb = t(p.lb)
        self.ub = t(p.ub)
        self.row_lb = t(p.row_lb)
        self.row_ub = t(p.row_ub)
        self.is_int = t(p.is_int, torch.bool)
        self.obj_integral = t(
            [
                bool(
                    np.all(p.C[j] == np.rint(p.C[j]))
                    and np.all(p.is_int[np.abs(p.C[j]) > 0])
                )
                for j in range(self.k)
            ],
            torch.bool,
        )
        self._bnb_steps = 0
        self._syncs = 0
        self.launches = 0
        self.plan_launches: Counter = Counter()
        self.lane_nodes = self.lane_iters = None
        self._pivots = None
        self._totals = [0, 0, 0, 0]  # nodes, iters, path nodes, path iters
        self._unread = []  # card calls whose counts are not in _totals yet

    def _plain_only(self, name: str):
        if self.lp is None:
            raise AttributeError(f"{name}: K6 runs no lockstep loop")

    @property
    def bnb_steps(self) -> int:
        self._plain_only("bnb_steps")
        return self._bnb_steps

    @property
    def lp_steps(self) -> int:
        self._plain_only("lp_steps")
        return self.lp.steps

    @property
    def lane_pivots(self):
        self._plain_only("lane_pivots")
        return self._pivots

    @property
    def host_syncs(self) -> int:
        return 0 if self.lp is None else self._syncs + self.lp.syncs

    def _count(self, nodes, iters) -> None:
        if nodes.numel():
            t = self._totals
            t[0] += int(nodes.sum())
            t[1] += int(iters.sum())
            t[2] += int(nodes.max())
            t[3] += int(iters.max())

    def _read(self, wait: bool) -> None:
        """Add the unread card calls' per-lane counts to the totals: every
        one (``wait``), or those whose launch has finished."""
        left = []
        for done, nodes, iters in self._unread:
            if wait or done.query():
                self._count(nodes.cpu(), iters.cpu())
            else:
                left.append((done, nodes, iters))
        self._unread = left

    def _total(self, i: int) -> int:
        self._read(wait=True)
        return self._totals[i]

    @property
    def nodes(self) -> int:
        return self._total(0)

    @property
    def iters(self) -> int:
        return self._total(1)

    @property
    def path_nodes(self) -> int:
        return self._total(2)

    @property
    def path_iters(self) -> int:
        return self._total(3)

    def _bnb(self, c_struct, obj_int, srhs, active):
        """Min ``c_struct @ x`` s.t. the structural rows, the objective rows
        bounded by ``srhs`` and integrality, for every lane.  Returns
        (found, resource, best obj, nodes, LP steps, pivots) a lane;
        ``active=False`` lanes start with an empty stack and take no
        step."""
        dev = self.device
        B = c_struct.shape[0]
        n, m, k, MAXN = self.n, self.m, self.k, self.maxn
        lanes = torch.arange(B, device=dev)
        free = torch.full((B, k), float("inf"), dtype=torch.float64, device=dev)
        if self.is_min:
            olo, ohi = -free, srhs
        else:
            olo, ohi = srhs, free
        lo_log = torch.cat([self.row_lb.expand(B, -1), olo], 1)
        hi_log = torch.cat([self.row_ub.expand(B, -1), ohi], 1)
        c_full = torch.cat([c_struct, torch.zeros(B, m, dtype=torch.float64, device=dev)], 1)
        tol = torch.where(
            obj_int,
            torch.tensor(INT_TOL, dtype=torch.float64, device=dev),
            torch.tensor(1e-9, dtype=torch.float64, device=dev),
        )

        stack_lo = torch.zeros(B, MAXN, n, dtype=torch.float64, device=dev)
        stack_hi = torch.zeros_like(stack_lo)
        stack_lo[:, 0] = self.lb
        stack_hi[:, 0] = self.ub
        sp = active.to(torch.int64)
        best = torch.full((B,), float("inf"), dtype=torch.float64, device=dev)
        nodes = torch.zeros(B, dtype=torch.int64, device=dev)
        iters = torch.zeros(B, dtype=torch.int64, device=dev)
        pivots = torch.zeros(B, dtype=torch.int64, device=dev)
        resource = torch.zeros(B, dtype=torch.bool, device=dev)
        unbounded = torch.zeros_like(resource)

        while True:
            go = (sp > 0) & ~resource & ~unbounded
            self._syncs += 1
            if not bool(go.any()):
                break
            self._bnb_steps += 1
            sp1 = sp - 1
            top = sp1.clamp(min=0)
            nlo = stack_lo[lanes, top]
            nhi = stack_hi[lanes, top]
            out = self.lp(
                c_full, torch.cat([nlo, lo_log], 1), torch.cat([nhi, hi_log], 1),
                active=go,
            )
            iters += torch.where(go, out.iters, 0)
            pivots += torch.where(go, self.lp.pivots, 0)
            nodes1 = nodes + 1
            res1 = resource | (nodes1 > self.max_bnb_nodes) | (out.status == ITER_LIMIT)
            unb1 = unbounded | (out.status == UNBOUNDED)

            feasible = out.status == OPTIMAL
            bound = torch.where(obj_int, _ceil_tol(out.obj), out.obj)
            pruned = bound >= best - tol
            x = out.x
            frac = torch.where(self.is_int, (x - torch.round(x)).abs(), 0.0)
            jvar = frac.argmax(1)
            jc = jvar[:, None]
            integral = frac.gather(1, jc).squeeze(1) <= INT_TOL
            improves = out.obj < best - INT_TOL
            take = go & feasible & ~pruned & integral & improves
            best = torch.where(take, out.obj, best)

            branch = feasible & ~pruned & ~integral
            overflow = branch & (sp1 + 2 > MAXN)
            res1 = res1 | overflow
            push = go & branch & ~overflow
            # push the "up" child first and the "down" child on top (the
            # DFS explores down first); a lane that does not push rewrites
            # the rows it read
            fl = torch.floor(x.gather(1, jc) + INT_TOL)
            up_lo = nlo.scatter(1, jc, fl + 1.0)
            dn_hi = nhi.scatter(1, jc, fl)
            nxt = (sp1 + 1).clamp(max=MAXN - 1)
            pushed = push[:, None]
            stack_lo[lanes, top] = torch.where(pushed, up_lo, nlo)
            stack_lo[lanes, nxt] = torch.where(pushed, nlo, stack_lo[lanes, nxt])
            stack_hi[lanes, nxt] = torch.where(pushed, dn_hi, stack_hi[lanes, nxt])

            sp = torch.where(go, torch.where(push, sp1 + 2, sp1), sp)
            nodes = torch.where(go, nodes1, nodes)
            resource = torch.where(go, res1, resource)
            unbounded = torch.where(go, unb1, unbounded)

        found = torch.isfinite(best) & ~resource
        return found, resource, best, nodes, iters, pivots

    def __call__(self, rhs, perm):
        """The batch's ``rhs`` and ``perm``, tensors or sequences of rows
        (packed here in NumPy), checked and moved to the device (span
        ``lex.pack``), then K6's launch or its plain version (``lex.launch``)."""
        dev = self.device
        with GLOBAL_TIMINGS.span("lex.pack"):
            if not torch.is_tensor(rhs):
                rhs = np.asarray(rhs, dtype=np.float64)
            if not torch.is_tensor(perm):
                perm = np.asarray(perm, dtype=np.int64)
            check_perm(perm, self.k)
            rhs = torch.as_tensor(rhs, dtype=torch.float64, device=dev).contiguous()
            perm = torch.as_tensor(perm, dtype=torch.int64, device=dev).contiguous()
            if rhs.dim() != 2 or rhs.shape[1] != self.k or perm.shape != rhs.shape:
                raise ValueError(f"rhs and perm must have shape (B, {self.k})")
        with GLOBAL_TIMINGS.span("lex.launch"):
            if dev.type == "cuda":
                return self._launch(rhs, perm)
            return self._plain(rhs, perm)

    def _launch(self, rhs, perm):
        """K6 on the batch: one launch, its outputs left on the card; a
        launch on the regs shape counts ``lex.plan.regs``, one on the
        regs_block shape ``lex.plan.regs_block``."""
        self._read(wait=False)
        launched = Counter()  # the launch's plan, as launch_lex_bnb records it
        out = launch_lex_bnb(
            self.W, rhs, perm, self.C, self.lb, self.ub, self.row_lb, self.row_ub,
            self.is_int, self.obj_integral, self.is_min, self.maxn, self.max_bnb_nodes,
            self.lp_max_iters, FEAS_TOL, COST_TOL, PIVOT_TOL, PROGRESS_TOL, STALL_LIMIT,
            plan_launches=launched,
        )
        self.plan_launches.update(launched)
        for shape in ("regs", "regs_block"):
            if any(s == shape for s, _, _ in launched):
                GLOBAL_TIMINGS.count(f"lex.plan.{shape}")
        self.launches += 1
        self.lane_nodes, self.lane_iters = out.nodes, out.iters
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        self._unread.append((done, out.nodes, out.iters))
        return out.status, out.results, out.ips

    def _plain(self, rhs, perm):
        """K6's plain version: the batch's stages, each a B&B loop over
        every lane at once."""
        dev = self.device
        B, k = rhs.shape
        sgn = 1.0 if self.is_min else -1.0
        srhs = rhs.clone()
        alive = torch.ones(B, dtype=torch.bool, device=dev)
        resource = torch.zeros_like(alive)
        result = torch.zeros(B, k, dtype=torch.int64, device=dev)
        ips = torch.zeros(B, dtype=torch.int32, device=dev)
        counts = torch.zeros(3, B, dtype=torch.int64, device=dev)  # nodes, iters, pivots
        for s in range(k):
            j = perm[:, s]
            active = alive & ~resource
            found, res_flag, obj, *stage_counts = self._bnb(
                sgn * self.C[j], self.obj_integral[j], srhs, active
            )
            counts += torch.stack(stage_counts)
            val = torch.round(obj if self.is_min else -obj)
            new_alive = alive & found & active
            jc = j[:, None]
            kept = new_alive[:, None]
            as_int = torch.where(new_alive, val, 0.0).to(torch.int64)[:, None]
            result.scatter_(1, jc, torch.where(kept, as_int, result.gather(1, jc)))
            srhs.scatter_(1, jc, torch.where(kept, val[:, None], srhs.gather(1, jc)))
            ips += active.to(torch.int32)
            alive = new_alive
            resource = resource | (res_flag & active)
        status = torch.where(
            resource, LEX_RESOURCE, torch.where(alive, LEX_OPTIMAL, LEX_INFEASIBLE)
        ).to(torch.int32)
        self.lane_nodes, self.lane_iters, self._pivots = counts
        self._count(self.lane_nodes, self.lane_iters)
        return status, result, ips


def make_lex_kernel(
    problem: Problem,
    max_nodes_stack: int = 160,
    max_bnb_nodes: int = 20000,
    lp_max_iters: int = 2000,
    device="cuda",
) -> LexKernel:
    """The batched lex kernel for one Problem on ``device`` (the reference's
    ``make_lex_kernel``, jitted over a ``vmap``; nothing compiles here)."""
    return LexKernel(problem, max_nodes_stack, max_bnb_nodes, lp_max_iters, device)


#: the LexKernel counters TorchLexBackend reports as its own
_KERNEL_COUNTERS = frozenset((
    "launches", "plan_launches", "nodes", "iters", "path_nodes", "path_iters",
    "bnb_steps", "lp_steps",
))


class TorchLexBackend:
    """The lex kernel as a backend, with the exact host fallback for
    resource-limited lanes.

    Requests go to the kernel ``batch_width`` at a time, and only the filled
    lanes launch: nothing compiles per shape, so the reference's padding to
    one static width has nothing to save.  Counters: ``device_batches``,
    ``lanes``, ``fallback_count`` (lanes re-solved by NumpyLexBackend), the
    kernel's ``launches`` and ``plan_launches`` (K6's), ``nodes``,
    ``iters``, ``path_nodes`` and ``path_iters``, the plain loop's
    ``bnb_steps`` and ``lp_steps`` (on the CPU only), and ``host_syncs``
    (the kernel's, with the one result copy of each batch)."""

    name = "jax"

    def __init__(self, problem: Problem, batch_width: int = 32, device="cuda", **kernel_kwargs):
        self.problem = problem
        self.batch_width = batch_width
        self.device = resolve_device(device)
        self.kernel = make_lex_kernel(problem, device=self.device, **kernel_kwargs)
        self._fallback = NumpyLexBackend(problem)
        self.device_batches = 0
        self.lanes = 0
        self.fallback_count = 0

    def __getattr__(self, name):
        # the kernel's counters, read through
        if name in _KERNEL_COUNTERS:
            return getattr(self.kernel, name)
        raise AttributeError(name)

    @property
    def host_syncs(self) -> int:
        return self.kernel.host_syncs + self.device_batches

    def lex_solve_batch(self, reqs: List[LexRequest]) -> List[LexOutcome]:
        out: List[LexOutcome] = []
        for i0 in range(0, len(reqs), self.batch_width):
            out.extend(self._solve_chunk(reqs[i0 : i0 + self.batch_width]))
        return out

    @spanned("lex.batch")
    def _solve_chunk(self, reqs: List[LexRequest]) -> List[LexOutcome]:
        outputs = self.kernel([r.rhs for r in reqs], [r.perm for r in reqs])
        # the host waits here for the card
        with GLOBAL_TIMINGS.span("lex.copy"):
            status, results, ips = (t.cpu().numpy() for t in outputs)
        self.device_batches += 1
        self.lanes += len(reqs)

        out: List[LexOutcome] = []
        with GLOBAL_TIMINGS.span("lex.unpack"):
            for i, req in enumerate(reqs):
                if status[i] == LEX_RESOURCE:
                    # exact host fallback for pathological lanes
                    self.fallback_count += 1
                    out.append(self._fallback.lex_solve(req))
                elif status[i] == LEX_OPTIMAL:
                    out.append(
                        LexOutcome(SolveStatus.OPTIMAL, results[i].astype(np.int64), int(ips[i]))
                    )
                else:
                    out.append(LexOutcome(SolveStatus.INFEASIBLE, None, int(ips[i])))
        return out

"""Batched lexicographic branch and bound in PyTorch — the port of
``moip_aira_tpu/solver/lex_jax.py`` (the ``jax`` backend).

One call solves a batch of CLMOIP subproblems on one device: for each lane,
a loop over the objective permutation runs a depth-first branch and bound
(a fixed-capacity node stack) whose LP relaxations are the f64 dense simplex
of solver/simplex_dense.py on the unscaled system ``[A; C | -I]``: on a
card one launch of K5 (csrc/simplex_dense.cu) a B&B step, on the CPU its
plain loop.  The B&B loop itself is plain PyTorch on either.

The reference is a ``vmap`` of a ``lax.scan`` over stages whose body is a
``lax.while_loop`` over B&B nodes, each node a ``lax.while_loop`` over
pivots.  Here the batch is explicit: each stage runs its B&B loop until no
lane's condition holds, and a lane whose condition is false, or whose LP is
done, is frozen (every update is masked by it), so each lane computes what
the reference's lane computes.  Lanes that overflow the node stack or hit an
iteration limit report ``LEX_RESOURCE``, and ``TorchLexBackend`` re-solves
them with the exact NumPy backend, counting each one.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from moip_aira_tpu_torch.device import resolve_device
from moip_aira_tpu_torch.problem import Problem
from moip_aira_tpu_torch.sense import Sense
from moip_aira_tpu_torch.solver.lex import LexOutcome, LexRequest, NumpyLexBackend
from moip_aira_tpu_torch.solver.simplex_dense import make_lp_solver
from moip_aira_tpu_torch.solver.simplex_torch import ITER_LIMIT, OPTIMAL, UNBOUNDED
from moip_aira_tpu_torch.solver.status import SolveStatus

__all__ = [
    "LEX_INFEASIBLE", "LEX_OPTIMAL", "LEX_RESOURCE", "LexKernel",
    "TorchLexBackend", "make_lex_kernel",
]

INT_TOL = 1e-6

# status codes for a lex solve lane
LEX_OPTIMAL = 0
LEX_INFEASIBLE = 1
LEX_RESOURCE = 3  # node stack overflow / iteration limit -> host fallback


def _ceil_tol(v):
    return torch.ceil(v - INT_TOL)


class LexKernel:
    """``fn(rhs (B, k) f64, perm (B, k) int) -> (status (B,) int32,
    results (B, k) int64, ips (B,) int32)``, tensors on ``device``.

    Counters: ``bnb_steps`` (steps of the B&B loops, one node of every
    running lane), ``lp_steps`` (steps of the LP loops, one pivot of every
    running lane; the same on the card and on the CPU) and ``host_syncs``
    (the host reading a loop condition, or K5's step count once a call)."""

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
        W = np.hstack([A_full, -np.eye(self.m)])
        self.lp = make_lp_solver(torch.as_tensor(W, dtype=f64, device=dev), lp_max_iters)

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
        self.bnb_steps = 0
        self._syncs = 0

    @property
    def lp_steps(self) -> int:
        return self.lp.steps

    @property
    def host_syncs(self) -> int:
        return self._syncs + self.lp.syncs

    @property
    def plan_launches(self):
        return self.lp.plan_launches

    def _bnb(self, c_struct, obj_int, srhs, active):
        """Min ``c_struct @ x`` s.t. the structural rows, the objective rows
        bounded by ``srhs`` and integrality, for every lane.  Returns
        (found, resource, best obj); ``active=False`` lanes start with an
        empty stack and take no step."""
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
        resource = torch.zeros(B, dtype=torch.bool, device=dev)
        unbounded = torch.zeros_like(resource)

        while True:
            go = (sp > 0) & ~resource & ~unbounded
            self._syncs += 1
            if not bool(go.any()):
                break
            self.bnb_steps += 1
            sp1 = sp - 1
            top = sp1.clamp(min=0)
            nlo = stack_lo[lanes, top]
            nhi = stack_hi[lanes, top]
            out = self.lp(
                c_full, torch.cat([nlo, lo_log], 1), torch.cat([nhi, hi_log], 1),
                active=go,
            )
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
        return found, resource, best

    def __call__(self, rhs, perm):
        dev = self.device
        rhs = torch.as_tensor(rhs, dtype=torch.float64, device=dev)
        perm = torch.as_tensor(perm, dtype=torch.int64, device=dev)
        B, k = rhs.shape
        sgn = 1.0 if self.is_min else -1.0
        srhs = rhs.clone()
        alive = torch.ones(B, dtype=torch.bool, device=dev)
        resource = torch.zeros_like(alive)
        result = torch.zeros(B, k, dtype=torch.int64, device=dev)
        ips = torch.zeros(B, dtype=torch.int32, device=dev)
        for s in range(k):
            j = perm[:, s]
            active = alive & ~resource
            found, res_flag, obj = self._bnb(
                sgn * self.C[j], self.obj_integral[j], srhs, active
            )
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


class TorchLexBackend:
    """The lex kernel as a backend, with the exact host fallback for
    resource-limited lanes.

    Requests go to the kernel ``batch_width`` at a time, and only the filled
    lanes launch: nothing compiles per shape, so the reference's padding to
    one static width has nothing to save.  Counters: ``device_batches``,
    ``lanes``, ``fallback_count`` (lanes re-solved by NumpyLexBackend) and
    the kernel's ``bnb_steps``, ``lp_steps`` and ``host_syncs`` (with the
    one result copy of each batch), and its LP solver's ``plan_launches``
    (K5's launches by plan)."""

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

    @property
    def bnb_steps(self) -> int:
        return self.kernel.bnb_steps

    @property
    def lp_steps(self) -> int:
        return self.kernel.lp_steps

    @property
    def host_syncs(self) -> int:
        return self.kernel.host_syncs + self.device_batches

    @property
    def plan_launches(self):
        return self.kernel.plan_launches

    def lex_solve_batch(self, reqs: List[LexRequest]) -> List[LexOutcome]:
        out: List[LexOutcome] = []
        for i0 in range(0, len(reqs), self.batch_width):
            out.extend(self._solve_chunk(reqs[i0 : i0 + self.batch_width]))
        return out

    def _solve_chunk(self, reqs: List[LexRequest]) -> List[LexOutcome]:
        rhs = np.array([np.asarray(r.rhs, dtype=np.float64) for r in reqs])
        perm = np.array([list(r.perm) for r in reqs], dtype=np.int64)
        status, results, ips = (t.cpu().numpy() for t in self.kernel(rhs, perm))
        self.device_batches += 1
        self.lanes += len(reqs)

        out: List[LexOutcome] = []
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

"""Batched dense bounded-variable simplex in PyTorch — the port of
``moip_aira_tpu/solver/simplex_jax.py``.

The LP solver of the monolithic lex backend (solver/lex_torch.py): the
algorithm and tolerances of ``simplex_jax.make_lp_solver`` (logical-variable
form ``[A | -I] z = 0``, composite phase 1, Dantzig pricing that becomes
Bland's rule after ``STALL_LIMIT`` pivots without a material objective
improvement, a bounded ratio test with bound flips and a largest-|pivot|
tie-break) on a batch of lanes, one dense tableau (m, n + m) per lane, in
the dtype of W (float64 for the lex backend).

The reference's ``lax.while_loop`` under ``vmap`` runs until no lane is
RUNNING, and a lane whose loop condition is false is frozen: its state is
left as it was.  Here the same loop is written out by hand over the batch:
every step computes the pivot of every lane and keeps it only where the lane
is still running, and the host reads the loop condition after each step.
Sums are ``torch.sum`` and ``@`` reductions, and the rank-1 tableau update
and the basic values' step are fused multiply-adds (``addcmul``), as XLA's
CPU backend computes them: on the CPU the pivots of the bundled instances
then follow the reference's bit for bit.  This is not K1's plain version
(``simplex_torch.dense_lp_batch_ref``), which sums term by term to match
its CUDA kernel and has its own pivot floor and warm start.

On a CUDA device the start and each step of the loop are CUDA graphs,
captured once per batch size: a step is about 140 small kernels, which the
host would otherwise launch one at a time.
"""

from __future__ import annotations

import torch

from moip_aira_tpu_torch.solver.simplex_np import (
    COST_TOL,
    FEAS_TOL,
    PIVOT_TOL,
    STALL_LIMIT,
)
from moip_aira_tpu_torch.solver.simplex_torch import (
    BIG,
    INFEASIBLE,
    ITER_LIMIT,
    RUNNING,
    UNBOUNDED,
    LPOutcome,
)

__all__ = ["DenseLPSolver", "LPOutcome", "make_lp_solver"]


class DenseLPSolver:
    """``solve(c, lo, hi, active=None) -> LPOutcome`` over a batch of lanes,
    closed over the system matrix W = [A | -I] (m, n + m).

    ``c``, ``lo`` and ``hi`` are (B, n + m) tensors on W's device, with
    +-inf allowed in the bounds.  A lane whose ``active`` entry is False
    takes no pivot and reports INFEASIBLE.  ``steps`` counts the loop's
    steps (one pivot or bound flip of every running lane) and ``syncs`` the
    times the host read the loop condition from the device."""

    def __init__(
        self,
        W: torch.Tensor,
        max_iters: int,
        feas_tol: float = FEAS_TOL,
        cost_tol: float = COST_TOL,
        pivot_tol: float = PIVOT_TOL,
        progress_tol: float = 1e-12,
        stall_limit: int = STALL_LIMIT,
    ):
        self.W = W
        self.m, self.nc = W.shape
        self.n = self.nc - self.m
        self.max_iters = max_iters
        self.feas_tol = feas_tol
        self.cost_tol = cost_tol
        self.pivot_tol = pivot_tol
        self.progress_tol = progress_tol
        self.stall_limit = stall_limit
        self.T0 = -W  # the tableau of the logical basis B = -I
        self.neg_col = -torch.arange(self.nc, device=W.device, dtype=W.dtype)
        self.steps = 0
        self.syncs = 0
        self._graphs = {}  # batch size -> (inputs, lanes, start and step graphs)

    def __call__(self, c, lo, hi, active=None) -> LPOutcome:
        if c.is_cuda:
            S, step = self._graphed(c, lo, hi, active)
        else:
            S = self._start(c, lo, hi, active)
            step = lambda: self._step(S)  # noqa: E731
        while True:
            self.syncs += 1
            if not bool(S.any_run):
                break
            self.steps += 1
            step()
        return self._finish(S)

    def _graphed(self, c, lo, hi, active):
        """On a CUDA device the start and each step are CUDA graphs of their
        small kernels (a step has about 140), captured once per batch size
        on buffers each call copies its lanes into: the host then launches
        one graph a step instead of one kernel at a time."""
        B = c.shape[0]
        if active is None:
            active = torch.ones(B, dtype=torch.bool, device=c.device)
        if B not in self._graphs:
            inp = (c.clone(), lo.clone(), hi.clone(), active.clone())
            static = self._start(*inp)

            def start():
                for key, value in vars(self._start(*inp)).items():
                    buf = getattr(static, key)
                    if value is not buf:
                        buf.copy_(value)

            with torch.cuda.device(c.device):
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    for _ in range(2):  # warm-up: cuBLAS and the allocator
                        start()
                        self._step(static)
                torch.cuda.current_stream().wait_stream(side)
                start_graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(start_graph):
                    start()
                step_graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(step_graph):
                    self._step(static)
            self._graphs[B] = (inp, static, start_graph, step_graph)
        inp, static, start_graph, step_graph = self._graphs[B]
        for buf, value in zip(inp, (c, lo, hi, active)):
            buf.copy_(value)
        start_graph.replay()
        return static, step_graph.replay

    def _start(self, c, lo, hi, active):
        """Each lane's constants and its state at the logical basis."""
        W = self.W
        dev, dt = W.device, W.dtype
        m, nc, n = self.m, self.nc, self.n
        B = c.shape[0]
        S = _Lanes()
        S.c = c
        fin_lo = torch.isfinite(lo)
        fin_hi = torch.isfinite(hi)
        S.free = ~fin_lo & ~fin_hi
        # a nonbasic column's value at its lower and at its upper bound
        # (a free column sits at 0), and its bound flip's length
        S.zlo = torch.where(fin_lo, lo, torch.where(fin_hi, hi, 0.0))
        S.zup = torch.where(fin_hi, hi, S.zlo)
        S.span = torch.where(fin_lo & fin_hi, hi - lo, float("inf"))
        S.LH = torch.stack([lo, hi], 1)
        S.neg_col = self.neg_col

        in_basis = torch.zeros(B, nc, dtype=torch.bool, device=dev)
        in_basis[:, n:] = True
        S.atu = torch.zeros(B, nc, dtype=torch.bool, device=dev)
        S.atu[:, :n] = ~fin_lo[:, :n] & fin_hi[:, :n]
        S.basis = (n + torch.arange(m, device=dev)).expand(B, m).clone()
        zv = torch.where(in_basis, 0.0, torch.where(S.atu, S.zup, S.zlo))
        S.xB = -(self.T0[None] * zv[:, None, :]).sum(2)
        S.T = self.T0.expand(B, m, nc).clone()

        skip = (lo > hi + self.feas_tol).any(1)  # an empty box is INFEASIBLE
        if active is not None:
            skip = skip | ~active
        S.status = torch.where(skip, INFEASIBLE, RUNNING).to(torch.int32)
        S.p1 = torch.ones(B, dtype=torch.bool, device=dev)  # phase 1
        S.stall = torch.zeros(B, dtype=torch.int32, device=dev)
        S.last = torch.full((B,), float("inf"), dtype=dt, device=dev)
        S.it = torch.zeros(B, dtype=torch.int32, device=dev)
        S.run = (S.status == RUNNING) & (S.it < self.max_iters)
        S.any_run = S.run.any()
        return S

    def _step(self, S) -> None:
        """One pivot or bound flip of every running lane, in place; the
        other lanes keep their state.  Ends with each lane's loop
        condition in ``S.run``."""
        ft, ct = self.feas_tol, self.cost_tol
        B, m, nc = S.T.shape
        dt = S.T.dtype
        run = S.run
        basis = S.basis

        bounds = S.LH.gather(2, basis[:, None, :].expand(B, 2, m))
        bl, bh = bounds[:, 0], bounds[:, 1]
        xB = S.xB
        below = xB < bl - ft
        above = xB > bh + ft
        infeas = torch.where(below, bl - xB, torch.where(above, xB - bh, 0.0)).sum(1)
        p1 = S.p1 & (infeas > ft)  # phase 1 ends once the basis is feasible
        entered = S.p1 & ~p1
        stall = torch.where(entered, 0, S.stall)
        last = torch.where(entered, float("inf"), S.last)

        cBb = S.c.gather(1, basis)
        cB = torch.where(p1[:, None], above.to(dt) - below.to(dt), cBb)
        in_basis = torch.zeros_like(S.atu).scatter_(1, basis, True)
        zv = torch.where(in_basis, 0.0, torch.where(S.atu, S.zup, S.zlo))
        d = torch.where(p1[:, None], 0.0, S.c) - (cB[:, None, :] @ S.T).squeeze(1)
        cur = torch.where(p1, infeas, (cBb * xB).sum(1) + (S.c * zv).sum(1))

        # the entering column: the largest |d| among the columns that can
        # move (up from a lower bound on d < 0, down from an upper one on
        # d > 0, either way when free), or the lowest one under Bland's
        # rule, which reads the stall count the step started with
        bland = (S.stall >= self.stall_limit)[:, None]
        ad = d.abs()
        elig = ~in_basis & torch.where(S.free, ad > ct, torch.where(S.atu, d, -d) > ct)
        score = torch.where(
            elig,
            torch.where(bland, S.neg_col, ad),
            torch.where(bland, -BIG, -1.0),
        )
        q = score.argmax(1, keepdim=True)
        any_elig = elig.any(1)
        sigma = torch.where(d.gather(1, q) < 0, 1.0, -1.0)  # up on d < 0
        alpha = S.T.gather(2, q[:, :, None].expand(B, m, 1)).squeeze(2)
        eta = -sigma * alpha

        # the bounded ratio test: each moving row's step to the bound it
        # heads for (an infinite bound gives an infinite step), the least
        # one, and among the rows tied within feas_tol the one of largest
        # |eta| (Bland: the lowest basic column)
        ae = eta.abs()
        neg = eta < 0
        num = torch.where(neg, xB - torch.where(above, bh, bl), torch.where(below, bl, bh) - xB)
        valid = (ae > self.pivot_tol) & ~torch.where(neg, below, above)
        ratios = torch.where(valid, num / ae, float("inf")).clamp_min(0.0)
        rmin = ratios.amin(1, keepdim=True)
        tied = ratios <= rmin + ft
        pick = torch.where(
            tied,
            torch.where(bland, -basis.to(dt), ae),
            torch.where(bland, -BIG, -1.0),
        )
        r = pick.argmax(1, keepdim=True)
        flip = S.span.gather(1, q)
        row_blocks = rmin < flip
        theta = torch.where(row_blocks, ratios.gather(1, r), flip)

        # status: OPTIMAL (INFEASIBLE in phase 1) with no eligible column,
        # UNBOUNDED (INFEASIBLE in phase 1) on an infinite step
        code = p1.to(torch.int32)  # INFEASIBLE = 1, OPTIMAL = 0
        status = torch.where(
            any_elig,
            torch.where(torch.isfinite(theta.squeeze(1)), RUNNING, UNBOUNDED - code),
            code,
        )
        status = torch.where(run, status, S.status)
        moves = run & (status == RUNNING)
        do_pivot = (moves[:, None] & row_blocks)
        do_flip = moves[:, None] & ~row_blocks

        # bound statuses: the entering column flips, or the leaving one
        # takes the bound its row hit
        p_col = basis.gather(1, r)
        at_q = S.atu.gather(1, q)
        leave_up = torch.where(neg, above, ~below).gather(1, r)
        S.atu.scatter_(
            1, torch.where(do_pivot, p_col, q), torch.where(do_pivot, leave_up, at_q ^ do_flip)
        )

        # the step: basic values move along eta; a pivot puts q's value in
        # row r and swaps q into row r of the tableau
        newval = zv.gather(1, q) + sigma * theta
        xB_new = torch.addcmul(xB, eta, theta)
        xB_new.scatter_(1, r, torch.where(do_pivot, newval, xB_new.gather(1, r)))
        S.xB.copy_(torch.where(moves[:, None], xB_new, xB))
        piv = alpha.gather(1, r)
        r3 = r[:, :, None].expand(B, 1, nc)
        T_r = S.T.gather(1, r3)
        row = torch.where(
            do_pivot[:, :, None], T_r / torch.where(piv.abs() > 0, piv, 1.0)[:, :, None], 0.0
        )
        colv = torch.where(do_pivot, alpha, 0.0).scatter_(1, r, 0.0)
        S.T.addcmul_(colv[:, :, None], row, value=-1.0)
        S.T.scatter_(1, r3, torch.where(do_pivot[:, :, None], row, T_r))
        basis.scatter_(1, r, torch.where(do_pivot, q, p_col))

        # watermark stall detection: only a material improvement of the
        # best objective seen resets the counter
        progressed = cur < last - self.progress_tol
        S.stall.copy_(torch.where(run, torch.where(progressed, 0, stall + 1), S.stall))
        S.last.copy_(torch.where(run, torch.minimum(last, cur), S.last))
        S.p1.copy_(torch.where(run, p1, S.p1))
        S.it.add_(run.to(torch.int32))
        S.status.copy_(status)
        S.run.copy_((status == RUNNING) & (S.it < self.max_iters))
        S.any_run.copy_(S.run.any())

    def _finish(self, S) -> LPOutcome:
        status = torch.where(S.status == RUNNING, ITER_LIMIT, S.status).to(torch.int32)
        in_basis = torch.zeros_like(S.atu).scatter_(1, S.basis, True)
        z = torch.where(in_basis, 0.0, torch.where(S.atu, S.zup, S.zlo))
        z = z.scatter(1, S.basis, S.xB)
        return LPOutcome(
            status=status,
            obj=(S.c * z).sum(1),
            x=z[:, : self.n],
            basis=S.basis.clone(),
            at_upper=S.atu.clone(),
            iters=S.it.clone(),
        )


class _Lanes:
    """One call's lanes: constants and simplex state, as tensors."""


def make_lp_solver(
    W: torch.Tensor,
    max_iters: int,
    feas_tol: float = FEAS_TOL,
    cost_tol: float = COST_TOL,
    pivot_tol: float = PIVOT_TOL,
    progress_tol: float = 1e-12,
    stall_limit: int = STALL_LIMIT,
) -> DenseLPSolver:
    """The LP solver over the static system matrix W = [A | -I], working in
    W's dtype on W's device (``simplex_jax.make_lp_solver``'s signature;
    the batch is the tensors' leading axis instead of a ``vmap``)."""
    return DenseLPSolver(
        W, max_iters, feas_tol, cost_tol, pivot_tol, progress_tol, stall_limit
    )

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
left as it was.  On the CPU the same loop is written out by hand over the
batch: every step computes the pivot of every lane and keeps it only where
the lane is still running, and the host reads the loop condition after
each step.  On a CUDA device the whole loop is K5 (csrc/simplex_dense.cu,
launched by solver/cuda_dense.py), one launch a call; this loop is its
plain version.  On the card the lex backend runs the same loop inside K6
(csrc/lex_bnb.cu), one lane at every node of its branch and bound.

Every sum follows XLA's CPU code for the reference, in float32 and float64
alike (``xla_sum``, ``xla_dot``): term by term up to 32 terms, longer axes
in windows of 32 zero-padded at both ends; a short sum of products is a
chain of fused multiply-adds; the rank-1 tableau update and the basic
values' step are fused multiply-adds (``addcmul``, fused on the CPU), and
the step rounds row 0's product apart when m <= 32, as XLA's unrolled loop
does.  The pivots then equal the reference's bit for bit
(tests/test_torch_wave_xla.py, tests/test_torch_dense_order.py), and no
result depends on a BLAS or on the CPU's vector width.  K5 computes each
of these operations in the same order, so on the card the pivots are the
same.  This is not K1's plain version (``simplex_torch.dense_lp_batch_ref``),
which sums term by term to match its CUDA kernel and has its own pivot
floor and warm start.
"""

from __future__ import annotations

from collections import Counter

import torch

from moip_aira_tpu_torch.solver.cuda_dense import (
    XLA_WINDOW,
    check_lanes,
    launch_dense_loop,
    pad_low,
    windows,
)
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

#: the least objective change a step counts as progress (simplex_jax's
#: default): stall_limit steps with less turn pricing to Bland's rule
PROGRESS_TOL = 1e-12

__all__ = ["DenseLPSolver", "LPOutcome", "make_lp_solver"]


#: the plain loop steps only its running lanes once at most half of the
#: lanes it holds still run and they hold at least this many tableau
#: entries: below it a step costs its operations' overhead, not their size
#: (on a CPU, 32 2AP40 lanes took a third of the time so, the lex backend's
#: G2AP05 front, 444 entries a lane, a tenth more)
COMPACT_MIN_ENTRIES = 1 << 16


class DenseLPSolver:
    """``solve(c, lo, hi, active=None) -> LPOutcome`` over a batch of lanes,
    closed over the system matrix W = [A | -I] (m, n + m).

    ``c``, ``lo`` and ``hi`` are contiguous (B, n + m) tensors of W's dtype
    on W's device, with +-inf allowed in the bounds.  A lane whose
    ``active`` entry is False takes no pivot and reports INFEASIBLE.  On a
    CUDA device a call is one launch of K5; on the CPU it runs the plain
    loop.  ``steps`` counts the loop's steps (one pivot or bound flip of
    every running lane; the largest ``iters`` of each call), ``syncs`` the
    times the host read the device (the plain loop's condition after each
    step, K5's largest ``iters`` once a call) and ``launches`` K5's
    launches, ``plan_launches`` them by the plan's (shape, C, P)
    (``cuda_dense.dense_loop_plan``).  ``pivots`` holds, after a call of
    the plain loop, each lane's pivots: its ``iters`` less its bound flips
    and its last, pricing-only step (K5 does not count them; None until
    then)."""

    def __init__(
        self,
        W: torch.Tensor,
        max_iters: int,
        feas_tol: float = FEAS_TOL,
        cost_tol: float = COST_TOL,
        pivot_tol: float = PIVOT_TOL,
        progress_tol: float = PROGRESS_TOL,
        stall_limit: int = STALL_LIMIT,
    ):
        self.W = W.contiguous()
        self.m, self.nc = W.shape
        self.n = self.nc - self.m
        self.max_iters = max_iters
        self.feas_tol = feas_tol
        self.cost_tol = cost_tol
        self.pivot_tol = pivot_tol
        self.progress_tol = progress_tol
        self.stall_limit = stall_limit
        self.T0 = -self.W  # the tableau of the logical basis B = -I
        self.neg_col = -torch.arange(self.nc, device=W.device, dtype=W.dtype)
        self.steps = 0
        self.syncs = 0
        self.launches = 0
        self.plan_launches: Counter = Counter()
        self.pivots = None

    def __call__(self, c, lo, hi, active=None) -> LPOutcome:
        if self.W.is_cuda:
            out = launch_dense_loop(
                self.W, c, lo, hi, active, self.max_iters, self.feas_tol,
                self.cost_tol, self.pivot_tol, self.progress_tol, self.stall_limit,
                plan_launches=self.plan_launches,
            )
            if c.shape[0]:  # a launch, and one host read of its step count
                self.launches += 1
                self.syncs += 1
                self.steps += int(out.iters.max())
            return out
        check_lanes(self.W, c, lo, hi, active)
        if c.device.type != "cpu":
            raise ValueError(f"no dense simplex for device {c.device}")
        full = S = self._start(c, lo, hi, active)
        rows = None  # the lanes S holds, where it holds fewer than all
        while True:
            self.syncs += 1
            running = int(S.run.sum())
            if not running:
                break
            held = S.run.shape[0]
            if 2 * running <= held and held * self.m * self.nc >= COMPACT_MIN_ENTRIES:
                # step only the running lanes: the others are frozen, and
                # no lane's arithmetic reads another's
                keep = S.run.nonzero().squeeze(1)
                if rows is not None:
                    full.put(rows, S)
                rows = keep if rows is None else rows[keep]
                S = S.take(keep)
            self.steps += 1
            self._step(S)
        if rows is not None:
            full.put(rows, S)
        self.pivots = full.npiv
        return self._finish(full)

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
        S.xB = -xla_dot(self.T0[None], zv[:, None, :], 2)
        S.T = self.T0.expand(B, m, nc).clone()

        skip = (lo > hi + self.feas_tol).any(1)  # an empty box is INFEASIBLE
        if active is not None:
            skip = skip | ~active
        S.status = torch.where(skip, INFEASIBLE, RUNNING).to(torch.int32)
        S.p1 = torch.ones(B, dtype=torch.bool, device=dev)  # phase 1
        S.stall = torch.zeros(B, dtype=torch.int32, device=dev)
        S.last = torch.full((B,), float("inf"), dtype=dt, device=dev)
        S.it = torch.zeros(B, dtype=torch.int32, device=dev)
        S.npiv = torch.zeros(B, dtype=torch.int32, device=dev)
        S.run = (S.status == RUNNING) & (S.it < self.max_iters)
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
        infeas = xla_sum(torch.where(below, bl - xB, 0.0), 1) + xla_sum(
            torch.where(above, xB - bh, 0.0), 1
        )
        p1 = S.p1 & (infeas > ft)  # phase 1 ends once the basis is feasible
        entered = S.p1 & ~p1
        stall = torch.where(entered, 0, S.stall)
        last = torch.where(entered, float("inf"), S.last)

        cBb = S.c.gather(1, basis)
        cB = torch.where(p1[:, None], above.to(dt) - below.to(dt), cBb)
        in_basis = torch.zeros_like(S.atu).scatter_(1, basis, True)
        zv = torch.where(in_basis, 0.0, torch.where(S.atu, S.zup, S.zlo))
        d = torch.where(p1[:, None], 0.0, S.c) - xla_dot(cB[:, :, None], S.T, 1)
        cur = torch.where(p1, infeas, xla_dot(cBb, xB, 1) + xla_sum(S.c * zv, 1))

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
        if m <= XLA_WINDOW:
            # XLA unrolls this loop over at most XLA_WINDOW rows and keeps
            # row 0's product apart from its sum: one rounding more there
            xB_new[:, 0] = xB[:, 0] + eta[:, 0] * theta[:, 0]
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
        S.npiv.add_(do_pivot.squeeze(1).to(torch.int32))
        S.status.copy_(status)
        S.run.copy_((status == RUNNING) & (S.it < self.max_iters))

    def _finish(self, S) -> LPOutcome:
        status = torch.where(S.status == RUNNING, ITER_LIMIT, S.status).to(torch.int32)
        in_basis = torch.zeros_like(S.atu).scatter_(1, S.basis, True)
        z = torch.where(in_basis, 0.0, torch.where(S.atu, S.zup, S.zlo))
        z = z.scatter(1, S.basis, S.xB)
        return LPOutcome(
            status=status,
            obj=xla_dot(S.c, z, 1),
            x=z[:, : self.n],
            basis=S.basis.clone(),
            at_upper=S.atu.clone(),
            iters=S.it.clone(),
        )


def xla_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum of ``x`` over ``dim`` in the order XLA's CPU backend adds a
    float32 or float64 reduction: term by term from the first while the
    axis has at most ``XLA_WINDOW`` terms, else each window of
    ``XLA_WINDOW`` terms so (``windows(L)`` of them, ``pad_low(L)`` zeros
    low and the rest high: cuda_dense's rule, which K5 follows), then the
    windows' sums the same way."""
    x = x.movedim(dim, -1)
    L = x.shape[-1]
    if L > XLA_WINDOW:
        nw, lo = windows(L), pad_low(L)
        x = torch.nn.functional.pad(x, (lo, nw * XLA_WINDOW - L - lo))
        x = x.unflatten(-1, (nw, XLA_WINDOW))
        return xla_sum(xla_sum(x, -1), -1)
    terms = x.unbind(-1)
    if L == 1:
        return terms[0]
    acc = terms[0] + terms[1]
    for t in terms[2:]:
        acc.add_(t)
    return acc


def xla_dot(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum over ``dim`` of the products ``a * b`` (broadcast) as XLA's
    CPU backend computes it in float32 and float64: a chain of fused
    multiply-adds (``addcmul``, fused on the CPU), term by term, while the
    axis has at most ``XLA_WINDOW`` terms, else the rounded products summed
    by ``xla_sum``."""
    a, b = torch.broadcast_tensors(a, b)
    a = a.movedim(dim, -1)
    b = b.movedim(dim, -1)
    L = a.shape[-1]
    if L > XLA_WINDOW:
        return xla_sum(a * b, -1)
    terms = zip(a.unbind(-1), b.unbind(-1))
    u, v = next(terms)
    acc = u * v
    for u, v in terms:
        acc.addcmul_(u, v)
    return acc


class _Lanes:
    """One call's lanes: constants and simplex state, as tensors whose
    first axis is the lane (``neg_col`` is shared)."""

    #: what a step changes
    STATE = ("atu", "basis", "xB", "T", "status", "p1", "stall", "last", "it", "npiv", "run")

    def take(self, rows: torch.Tensor) -> "_Lanes":
        """The lanes ``rows``, copied."""
        sub = _Lanes()
        for k, v in vars(self).items():
            setattr(sub, k, v if k == "neg_col" else v[rows])
        return sub

    def put(self, rows: torch.Tensor, sub: "_Lanes") -> None:
        """Write the state of ``sub``'s lanes back as the lanes ``rows``."""
        for k in self.STATE:
            getattr(self, k)[rows] = getattr(sub, k)


def make_lp_solver(
    W: torch.Tensor,
    max_iters: int,
    feas_tol: float = FEAS_TOL,
    cost_tol: float = COST_TOL,
    pivot_tol: float = PIVOT_TOL,
    progress_tol: float = PROGRESS_TOL,
    stall_limit: int = STALL_LIMIT,
) -> DenseLPSolver:
    """The LP solver over the static system matrix W = [A | -I], working in
    W's dtype on W's device (``simplex_jax.make_lp_solver``'s signature;
    the batch is the tensors' leading axis instead of a ``vmap``)."""
    return DenseLPSolver(
        W, max_iters, feas_tol, cost_tol, pivot_tol, progress_tol, stall_limit
    )

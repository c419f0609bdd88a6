"""Batched bounded-variable primal simplex in plain PyTorch.

The plain versions of the two LP kernels, which compute what the kernels
compute, lane by lane:

* ``dense_lp_batch_ref`` is K1, the dense-tableau kernel (the JAX package's
  ``solver/pallas_lp.py::make_pallas_lp_batch``; the CUDA kernel is
  ``csrc/dense_simplex.cu``).  A cold lane starts from the logical basis
  (tableau ``T = -W``); a warm lane (``wb[:, 0] >= 0``) rebuilds
  ``T = B^-1 W`` for its basis by Gauss-Jordan with greedy partial
  pivoting, and falls back to the cold start when that basis turns out
  singular.
* ``revised_lp_batch_ref`` is K2, the revised simplex (the JAX package's
  ``solver/pallas_rev.py::make_pallas_rev_batch``; the CUDA kernel is
  ``csrc/revised_simplex.cu``): the same pivots, with each lane carrying its
  basis inverse B^-1 in place of the tableau.

Both run composite phase 1, Dantzig pricing that becomes Bland's rule after
``STALL_LIMIT`` pivots without progress, a ratio test with bound flips and a
largest-|pivot| tie-break, and a rank-1 update.

The batch is written out by hand: every lane runs the same loop, masked by
its status, until no lane is RUNNING (a data-dependent trip count, which
``torch.func.vmap`` cannot batch).  Ties break as ``torch.argmax`` does, on
the first of equal maxima, which is what the reference's ``jnp.argmax`` does.
Every sum is taken term by term in index order (``_seq_sum``, ``_col_sums``,
``_row_sums``), as the CUDA kernels take it, so each plain version and its
kernel agree bit for bit on any device instead of drifting apart with each
backend's reduction order.

Inputs use the unpadded column layout ``[x | logicals]``: ``W`` is (m, nc)
with nc = n + m, ``c``/``lo``/``hi`` are (B, nc) with +-inf allowed in the
bounds, ``wb`` is (B, m) with -1 meaning cold, ``wa`` is (B, nc) at-upper
flags of a warm basis.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# status codes (the SolveStatus ints; the reference's simplex_jax.py:38-43)
OPTIMAL = 0
INFEASIBLE = 1
UNBOUNDED = 2
ITER_LIMIT = 3
RUNNING = -1

BIG = 1e30  # stand-in for +-inf inside ratio arithmetic
STALL_LIMIT = 60  # pivots without objective progress before Bland's rule
GJ_PIVOT_TOL = 1e-5  # smallest |pivot| the warm-basis rebuild accepts
PIVOT_FLOOR = 1e-12  # below this a simplex pivot divides by 1 instead


class LPOutcome(NamedTuple):
    status: torch.Tensor  # (B,) int32
    obj: torch.Tensor  # (B,) objective c.z of the final vertex
    x: torch.Tensor  # (B, n) structural values
    basis: torch.Tensor  # (B, m) int32 column of each basic variable
    at_upper: torch.Tensor  # (B, nc) int32 nonbasic-at-upper flags
    iters: torch.Tensor  # (B,) int32 pivots and bound flips taken


def _seq_sum(v):
    """Sum over the last axis, one term at a time in index order."""
    acc = torch.zeros_like(v[..., 0])
    for k in range(v.shape[-1]):
        acc = acc + v[..., k]
    return acc


def _nonbasic_values(at_upper, in_basis, lo, hi, fin_lo, fin_hi):
    """Value of every nonbasic column; 0 in the basic columns."""
    base = torch.where(fin_lo, lo, torch.where(fin_hi, hi, torch.zeros_like(lo)))
    zv = torch.where(at_upper & fin_hi, hi, base)
    return torch.where(in_basis, torch.zeros_like(zv), zv)


def _rank1(X, r, col, piv, div):
    """Pivot every lane's X (A, m, k) on row r with pivot column ``col``
    (A, m): ``X - colv (X_r / div)`` with ``colv = col`` except
    ``colv_r = piv - 1``, which divides row r by the pivot and eliminates
    the column from the others.  ``div`` is the pivot, or 1 where the
    simplex pivot is below PIVOT_FLOOR."""
    lanes = torch.arange(X.shape[0], device=X.device)
    rowdiv = X[lanes, r] / div[:, None]
    colv = col.clone()
    colv[lanes, r] = piv - 1.0
    return X - colv[:, :, None] * rowdiv[:, None, :]


def _entering(d, in_basis, at_upper, free, bland, cost_tol, neg_col):
    """Pricing choice: the entering column q of every lane (largest |d_j|,
    or the lowest eligible column under Bland's rule), whether it moves up
    from its bound, and whether any column was eligible at all."""
    nonbasic = ~in_basis
    can_up = nonbasic & (~at_upper | free) & (d < -cost_tol)
    can_dn = nonbasic & (at_upper | free) & (d > cost_tol)
    elig = can_up | can_dn
    score = torch.where(
        bland[:, None],
        torch.where(elig, neg_col, -BIG),
        torch.where(elig, d.abs(), -1.0),
    )
    return score.argmax(1), can_up, elig.any(1)


def _ratio_test(xB, bl, bh, below, above, eta, basis, bland, feas_tol, pivot_tol):
    """Bounded ratio test along ``eta`` (the basic values' rate of change):
    each row's step to its blocking bound, whether that bound is its upper
    one, the least step and the row that leaves (largest |eta| among the
    rows tied within feas_tol, or the lowest basic column under Bland)."""
    dtype = xB.dtype
    feas_b = ~below & ~above
    moving = eta.abs() > pivot_tol
    fin_bl = torch.isfinite(bl)
    fin_bh = torch.isfinite(bh)
    safe_e = torch.where(moving, eta, 1.0)
    r_dn = (xB - torch.where(fin_bl, bl, -BIG)) / (-safe_e)
    r_up = (torch.where(fin_bh, bh, BIG) - xB) / safe_e
    ratios = torch.full_like(xB, float("inf"))
    c1 = moving & feas_b & (eta < 0) & fin_bl
    ratios = torch.where(c1, r_dn, ratios)
    c2 = moving & feas_b & (eta > 0) & fin_bh
    ratios = torch.where(c2, r_up, ratios)
    c3 = moving & below & (eta > 0)
    ratios = torch.where(c3, (bl - xB) / safe_e, ratios)
    c4 = moving & above & (eta < 0)
    ratios = torch.where(c4, (xB - bh) / (-safe_e), ratios)
    ratios = ratios.clamp_min(0.0)
    rmin = ratios.amin(1)
    tied = ratios <= rmin[:, None] + feas_tol
    pick = torch.where(
        bland[:, None],
        torch.where(tied, -basis.to(dtype), -BIG),
        torch.where(tied, eta.abs(), -1.0),
    )
    return ratios, c2 | c4, rmin, pick.argmax(1)


def _step_status(any_elig, theta, phase1, active, status):
    """Each lane's status after this iteration's pricing and ratio test."""
    new_status = torch.where(
        ~any_elig,
        torch.where(phase1, INFEASIBLE, OPTIMAL),
        torch.where(
            ~torch.isfinite(theta),
            torch.where(phase1, INFEASIBLE, UNBOUNDED),
            RUNNING,
        ),
    ).to(torch.int32)
    return torch.where(active, new_status, status)


def _warm_rebuild(T, wb, warm, n):
    """Gauss-Jordan from ``T = W`` to ``B^-1 W`` for each warm lane's basis.

    The basis-to-row correspondence is free, so each step pivots on the
    (unassigned row, remaining basis column) entry of largest |T|; the first
    such entry in row-major order wins ties.  Returns (T, basis, ok) with ok
    False for lanes whose basis was singular (no remaining entry above
    GJ_PIVOT_TOL, the rule of ``_rev_warm_rebuild``) or that were cold."""
    B, m, nc = T.shape
    lanes = torch.arange(B, device=T.device)
    idx = torch.where(wb >= 0, wb.long(), torch.full_like(wb.long(), nc))
    rem = torch.zeros(B, nc + 1, dtype=T.dtype, device=T.device)
    rem.scatter_(1, idx, 1.0)
    rem = rem[:, :nc] * warm[:, None].to(T.dtype)
    unassigned = torch.ones(B, m, dtype=T.dtype, device=T.device)
    basis = (n + torch.arange(m, device=T.device)).expand(B, m).clone()
    ok = warm.clone()
    for _ in range(m):
        scores = T.abs() * unassigned[:, :, None] * rem[:, None, :]
        r = scores.amax(2).argmax(1)
        cb = scores[lanes, r].argmax(1)
        piv = T[lanes, r, cb]
        # the largest remaining score decides: when it is 0 the arg-max lands
        # on entry (0, 0), which may be an assigned row's
        act = ok & (scores[lanes, r, cb] > GJ_PIVOT_TOL)
        a = act.nonzero().squeeze(1)
        if a.numel():
            ra, ca, pa = r[a], cb[a], piv[a]
            T[a] = _rank1(T[a], ra, T[a, :, ca], pa, pa)
            unassigned[a, ra] = 0.0
            rem[a, ca] = 0.0
            basis[a, ra] = ca
        ok = act
    return T, basis, ok


def dense_lp_batch_ref(
    W: torch.Tensor,
    c: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    wb: torch.Tensor,
    wa: torch.Tensor,
    *,
    max_iters: int = 2000,
    feas_tol: float = 3e-4,
    cost_tol: float = 3e-5,
    pivot_tol: float = 3e-5,
    dtype: torch.dtype = torch.float32,
) -> LPOutcome:
    """Solve a batch of bounded LPs ``min c.z  s.t.  W z = 0, lo <= z <= hi``.

    All arithmetic runs in ``dtype`` on the device of ``c``."""
    dev = c.device
    W = W.to(device=dev, dtype=dtype)
    c = c.to(dtype)
    lo = lo.to(dtype)
    hi = hi.to(dtype)
    B, nc = c.shape
    m = W.shape[0]
    n = nc - m
    if W.shape[1] != nc or wb.shape != (B, m) or wa.shape != (B, nc):
        raise ValueError(
            f"shapes W{tuple(W.shape)} c{tuple(c.shape)} wb{tuple(wb.shape)} "
            f"wa{tuple(wa.shape)} do not agree"
        )
    lanes = torch.arange(B, device=dev)
    col = torch.arange(nc, device=dev)
    fin_lo = torch.isfinite(lo)
    fin_hi = torch.isfinite(hi)
    free = ~fin_lo & ~fin_hi
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)

    # ---- initial basis and tableau ----------------------------------------
    warm = wb[:, 0] >= 0
    T = torch.where(warm[:, None, None], W, -W).contiguous()
    basis_cold = (n + torch.arange(m, device=dev)).expand(B, m)
    basis = basis_cold.clone()
    use_warm = warm
    if bool(warm.any()):
        T, basis, ok = _warm_rebuild(T, wb.to(dev), warm, n)
        use_warm = warm & ok
        T = torch.where((warm & ~ok)[:, None, None], -W, T)
        basis = torch.where(use_warm[:, None], basis, basis_cold)
    in_basis = torch.zeros(B, nc, dtype=torch.bool, device=dev)
    in_basis.scatter_(1, basis, True)
    at0 = (col < n) & ~fin_lo & fin_hi
    at_upper = torch.where(
        use_warm[:, None], (wa.to(dev) > 0) & ~in_basis, at0 & ~in_basis
    )
    bl = lo.gather(1, basis)
    bh = hi.gather(1, basis)
    cB = c.gather(1, basis)
    zv0 = _nonbasic_values(at_upper, in_basis, lo, hi, fin_lo, fin_hi)
    xB = -_seq_sum(T * zv0[:, None, :])

    empty = (lo > hi + feas_tol).any(1)
    status = torch.where(
        empty,
        torch.tensor(INFEASIBLE, device=dev),
        torch.tensor(RUNNING, device=dev),
    ).to(torch.int32)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    stall = torch.zeros(B, dtype=torch.int32, device=dev)
    last = torch.full((B,), float("inf"), dtype=dtype, device=dev)
    neg_col = -col.to(dtype)

    for _ in range(max_iters):
        active = status == RUNNING
        if not bool(active.any()):
            break
        below = xB < bl - feas_tol
        above = xB > bh + feas_tol
        infeas = torch.where(below, bl - xB, 0.0) + torch.where(above, xB - bh, 0.0)
        infeas_sum = _seq_sum(infeas)
        phase1 = infeas_sum > feas_tol

        # ---- pricing -------------------------------------------------------
        cB_eff = torch.where(
            phase1[:, None],
            torch.where(below, -1.0, torch.where(above, 1.0, 0.0)).to(dtype),
            cB,
        )
        acc = torch.zeros_like(c)
        for i in range(m):
            acc = acc + cB_eff[:, i, None] * T[:, i, :]
        d = -acc
        d = torch.where(phase1[:, None], d, d + c)
        bland = stall >= STALL_LIMIT
        q, can_up, any_elig = _entering(
            d, in_basis, at_upper, free, bland, cost_tol, neg_col
        )
        sigma = torch.where(can_up[lanes, q], 1.0, -1.0).to(dtype)
        alpha = T[lanes, :, q]  # (B, m) entering column
        eta = -sigma[:, None] * alpha

        # ---- ratio test ----------------------------------------------------
        lo_q, hi_q = lo[lanes, q], hi[lanes, q]
        flo_q, fhi_q = fin_lo[lanes, q], fin_hi[lanes, q]
        lo_q0 = torch.where(flo_q, lo_q, 0.0)
        hi_q0 = torch.where(fhi_q, hi_q, 0.0)
        flip_theta = torch.where(flo_q & fhi_q, hi_q0 - lo_q0, inf)
        ratios, hits_up, rmin, r = _ratio_test(
            xB, bl, bh, below, above, eta, basis, bland, feas_tol, pivot_tol
        )
        row_blocks = rmin < flip_theta
        theta = torch.where(row_blocks, ratios[lanes, r], flip_theta)
        new_status = _step_status(
            any_elig, theta, phase1, active, status
        )
        stepping = active & (new_status == RUNNING)
        do_pivot = stepping & row_blocks
        do_flip = stepping & ~row_blocks

        # ---- apply ---------------------------------------------------------
        atq = at_upper[lanes, q]
        f = do_flip.nonzero().squeeze(1)
        at_upper[f, q[f]] = ~atq[f]

        zq = torch.where(atq, hi_q0, lo_q0)
        zq = torch.where(flo_q | fhi_q, zq, 0.0)
        xb_step = xB + eta * theta[:, None]
        moved = (do_pivot | do_flip)[:, None]

        p = do_pivot.nonzero().squeeze(1)
        if p.numel():
            rp, qp = r[p], q[p]
            piv = alpha[p, rp]
            safe_piv = torch.where(piv.abs() > PIVOT_FLOOR, piv, 1.0)
            T[p] = _rank1(T[p], rp, alpha[p], piv, safe_piv)
            p_col = basis[p, rp]
            at_upper[p, p_col] = hits_up[p, rp]
            in_basis[p, p_col] = False
            in_basis[p, qp] = True
            xb_step[p, rp] = zq[p] + sigma[p] * theta[p]
            basis[p, rp] = qp
            bl[p, rp] = lo[p, qp]
            bh[p, rp] = hi[p, qp]
            cB[p, rp] = c[p, qp]
        xB = torch.where(moved, xb_step, xB)

        # ---- objective and stall counter -----------------------------------
        cur_obj = torch.where(phase1, infeas_sum, _seq_sum(cB * xB))
        progressed = cur_obj < last - 1e-9
        stall = torch.where(progressed | ~active, 0, stall + 1).to(torch.int32)
        last = cur_obj
        status = new_status
        iters = iters + active.to(torch.int32)

    status = torch.where(status == RUNNING, ITER_LIMIT, status).to(torch.int32)
    z = _nonbasic_values(at_upper, in_basis, lo, hi, fin_lo, fin_hi)
    z = z.scatter_add(1, basis, xB)
    obj = _seq_sum(c * z)
    return LPOutcome(
        status,
        obj,
        z[:, :n],
        basis.to(torch.int32),
        at_upper.to(torch.int32),
        iters,
    )


def _col_sums(M, v):
    """``out[..., j] = sum_i v[..., i] * M[..., i, j]``, term by term in
    index order i, each product and each sum rounded on its own (no fused
    multiply-add), as the kernels compute it.  ``M`` is (B, m, k) or a
    shared (m, k)."""
    acc = torch.zeros_like(v[..., :1] * M[..., 0, :])
    for i in range(v.shape[-1]):
        acc = acc + v[..., i, None] * M[..., i, :]
    return acc


def _row_sums(M, v):
    """``out[..., i] = sum_k M[..., i, k] * v[..., k]``, term by term in
    index order k (see _col_sums)."""
    acc = torch.zeros_like(M[..., :, 0] * v[..., :1])
    for k in range(v.shape[-1]):
        acc = acc + M[..., :, k] * v[..., k, None]
    return acc


def _big_to_inf(v, lower, at):
    """A basic bound through the reference kernel's sentinel: values at or
    beyond ``at`` (BIG when the basis is first read, BIG / 2 when a column
    enters) become the infinity on their side."""
    if lower:
        return torch.where(v <= -at, -torch.inf, v)
    return torch.where(v >= at, torch.inf, v)


def _rev_warm_rebuild(W, wb, warm):
    """B^-1 of each warm lane's basis by a greedy Gauss-Jordan on [P1 | -I].

    P1 holds the basis columns W[:, wb[t]] in the order of ``wb``; each step
    pivots on the (unassigned row, remaining entry) of largest |P1|, the
    first such entry in row-major order on ties, and assigns that row to
    column wb[t].  Returns (BI, basis, ok) with ok False for lanes whose
    basis was singular (no remaining entry above GJ_PIVOT_TOL; the
    reference kernel tests the entry its argmax lands on, which for an
    all-zero remainder is an assigned row's) or that were cold.
    The row-op matrix that turns P1 into the identity is B^-1, so [P1 | -I]
    ends as [I | -B^-1]."""
    B, m = wb.shape
    nc = W.shape[1]
    lanes = torch.arange(B, device=W.device)
    valid = (wb >= 0) & (wb < nc)
    P1 = torch.where(
        valid[:, None, :], W[:, wb.long().clamp(0, nc - 1)].transpose(0, 1), 0.0
    ).contiguous()  # P1[b, j, t] = W[j, wb[b, t]]
    BI = -torch.eye(m, dtype=W.dtype, device=W.device).expand(B, m, m).clone()
    unassigned = torch.ones(B, m, dtype=torch.bool, device=W.device)
    remaining = torch.ones(B, m, dtype=torch.bool, device=W.device)
    basis = torch.zeros(B, m, dtype=torch.long, device=W.device)
    ok = warm.clone()
    for _ in range(m):
        scores = torch.where(
            unassigned[:, :, None] & remaining[:, None, :], P1.abs(), 0.0
        )
        flat = scores.reshape(B, m * m).argmax(1)
        r, t = flat // m, flat % m
        piv = P1[lanes, r, t]
        ok = ok & (scores[lanes, r, t] > GJ_PIVOT_TOL)
        a = ok.nonzero().squeeze(1)
        if a.numel() == 0:
            break
        ra, ta, pa = r[a], t[a], piv[a]
        pcol = P1[a, :, ta]
        P1[a] = _rank1(P1[a], ra, pcol, pa, pa)
        BI[a] = _rank1(BI[a], ra, pcol, pa, pa)
        basis[a, ra] = wb[a, ta].long()
        unassigned[a, ra] = False
        remaining[a, ta] = False
    return -BI, basis, ok


def revised_lp_batch_ref(
    W: torch.Tensor,
    c: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    wb: torch.Tensor,
    wa: torch.Tensor,
    *,
    max_iters: int = 2000,
    feas_tol: float = 3e-4,
    cost_tol: float = 3e-5,
    pivot_tol: float = 3e-5,
    dtype: torch.dtype = torch.float32,
) -> LPOutcome:
    """The plain version of K2, the revised simplex
    (``moip_aira_tpu/solver/pallas_rev.py::make_pallas_rev_batch``; the CUDA
    kernel is ``csrc/revised_simplex.cu``): the same contract and the same
    pivots as ``dense_lp_batch_ref``, with each lane carrying its basis
    inverse B^-1 (m, m) instead of the tableau.  Per iteration:

    * pricing ``y = c_B^T B^-1`` (a sum over rows i) and
      ``d = c - y W`` (a sum over rows k of the shared W);
    * the entering column ``alpha = B^-1 W[:, q]`` (a sum over k);
    * the ratio test of the dense kernel; the pivot is the product-form
      rank-1 update of B^-1.

    A warm lane rebuilds B^-1 by Gauss-Jordan on [P1 | -I]
    (``_rev_warm_rebuild``) and starts cold when that basis is singular.
    Basic bounds carry infinities; an infinite bound entering the basis
    goes through the reference's +-BIG sentinel and back.  Every sum runs
    term by term in index order with each step rounded, as in the kernel.
    All arithmetic runs in ``dtype`` on the device of ``c``."""
    dev = c.device
    W = W.to(device=dev, dtype=dtype)
    c = c.to(dtype)
    lo = lo.to(dtype)
    hi = hi.to(dtype)
    B, nc = c.shape
    m = W.shape[0]
    n = nc - m
    if W.shape[1] != nc or wb.shape != (B, m) or wa.shape != (B, nc):
        raise ValueError(
            f"shapes W{tuple(W.shape)} c{tuple(c.shape)} wb{tuple(wb.shape)} "
            f"wa{tuple(wa.shape)} do not agree"
        )
    wb = wb.to(dev)
    lanes = torch.arange(B, device=dev)
    col = torch.arange(nc, device=dev)
    fin_lo = torch.isfinite(lo)
    fin_hi = torch.isfinite(hi)
    free = ~fin_lo & ~fin_hi
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)

    # ---- initial basis and its inverse ------------------------------------
    warm = wb[:, 0] >= 0
    basis = (n + torch.arange(m, device=dev)).expand(B, m).clone()
    BI = -torch.eye(m, dtype=dtype, device=dev).expand(B, m, m).clone()
    use_warm = torch.zeros_like(warm)
    if bool(warm.any()):
        BI_w, basis_w, ok = _rev_warm_rebuild(W, wb, warm)
        use_warm = warm & ok
        BI = torch.where(use_warm[:, None, None], BI_w, BI)
        basis = torch.where(use_warm[:, None], basis_w, basis)
    in_basis = torch.zeros(B, nc, dtype=torch.bool, device=dev)
    in_basis.scatter_(1, basis, True)
    at0 = (col < n) & ~fin_lo & fin_hi
    at_upper = torch.where(
        use_warm[:, None], (wa.to(dev) > 0) & ~in_basis, at0 & ~in_basis
    )
    lo_s = torch.where(fin_lo, lo, torch.where(lo > 0, BIG, -BIG))
    hi_s = torch.where(fin_hi, hi, torch.where(hi > 0, BIG, -BIG))
    bl = _big_to_inf(lo_s.gather(1, basis), lower=True, at=BIG)
    bh = _big_to_inf(hi_s.gather(1, basis), lower=False, at=BIG)
    cB = c.gather(1, basis)
    zv0 = _nonbasic_values(at_upper, in_basis, lo, hi, fin_lo, fin_hi)
    xB = -_row_sums(BI, _row_sums(W, zv0))  # -B^-1 (W z_N)

    empty = (lo > hi + feas_tol).any(1)
    status = torch.where(
        empty,
        torch.tensor(INFEASIBLE, device=dev),
        torch.tensor(RUNNING, device=dev),
    ).to(torch.int32)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    stall = torch.zeros(B, dtype=torch.int32, device=dev)
    last = torch.full((B,), float("inf"), dtype=dtype, device=dev)
    neg_col = -col.to(dtype)

    for _ in range(max_iters):
        active = status == RUNNING
        if not bool(active.any()):
            break
        below = xB < bl - feas_tol
        above = xB > bh + feas_tol
        infeas = torch.where(below, bl - xB, 0.0) + torch.where(above, xB - bh, 0.0)
        infeas_sum = _seq_sum(infeas)
        phase1 = infeas_sum > feas_tol

        # ---- pricing: y = cB_eff^T B^-1, d = -(y W) [+ c] ------------------
        cB_eff = torch.where(
            phase1[:, None],
            torch.where(below, -1.0, torch.where(above, 1.0, 0.0)).to(dtype),
            cB,
        )
        d = -_col_sums(W, _col_sums(BI, cB_eff))
        d = torch.where(phase1[:, None], d, d + c)
        bland = stall >= STALL_LIMIT
        q, can_up, any_elig = _entering(
            d, in_basis, at_upper, free, bland, cost_tol, neg_col
        )
        sigma = torch.where(can_up[lanes, q], 1.0, -1.0).to(dtype)
        alpha = _row_sums(BI, W[:, q].T)  # B^-1 W[:, q]
        eta = -sigma[:, None] * alpha

        # ---- ratio test ----------------------------------------------------
        lo_q, hi_q = lo[lanes, q], hi[lanes, q]
        flo_q, fhi_q = fin_lo[lanes, q], fin_hi[lanes, q]
        lo_q0 = torch.where(flo_q, lo_q, 0.0)
        hi_q0 = torch.where(fhi_q, hi_q, 0.0)
        flip_theta = torch.where(flo_q & fhi_q, hi_q0 - lo_q0, inf)
        ratios, hits_up, rmin, r = _ratio_test(
            xB, bl, bh, below, above, eta, basis, bland, feas_tol, pivot_tol
        )
        row_blocks = rmin < flip_theta
        theta = torch.where(row_blocks, ratios[lanes, r], flip_theta)
        new_status = _step_status(any_elig, theta, phase1, active, status)
        stepping = active & (new_status == RUNNING)
        do_pivot = stepping & row_blocks
        do_flip = stepping & ~row_blocks

        # ---- apply ---------------------------------------------------------
        atq = at_upper[lanes, q]
        f = do_flip.nonzero().squeeze(1)
        at_upper[f, q[f]] = ~atq[f]

        zq = torch.where(atq, hi_q0, lo_q0)
        zq = torch.where(flo_q | fhi_q, zq, 0.0)
        xb_step = xB + eta * theta[:, None]
        moved = (do_pivot | do_flip)[:, None]

        p = do_pivot.nonzero().squeeze(1)
        if p.numel():
            rp, qp = r[p], q[p]
            piv = alpha[p, rp]
            safe_piv = torch.where(piv.abs() > PIVOT_FLOOR, piv, 1.0)
            BI[p] = _rank1(BI[p], rp, alpha[p], piv, safe_piv)
            p_col = basis[p, rp]
            at_upper[p, p_col] = hits_up[p, rp]
            in_basis[p, p_col] = False
            in_basis[p, qp] = True
            xb_step[p, rp] = zq[p] + sigma[p] * theta[p]
            basis[p, rp] = qp
            bl[p, rp] = _big_to_inf(
                torch.where(fin_lo[p, qp], lo[p, qp], -BIG), lower=True, at=BIG / 2
            )
            bh[p, rp] = _big_to_inf(
                torch.where(fin_hi[p, qp], hi[p, qp], BIG), lower=False, at=BIG / 2
            )
            cB[p, rp] = c[p, qp]
        xB = torch.where(moved, xb_step, xB)

        # ---- objective and stall counter -----------------------------------
        cur_obj = torch.where(phase1, infeas_sum, _seq_sum(cB * xB))
        progressed = cur_obj < last - 1e-9
        stall = torch.where(progressed | ~active, 0, stall + 1).to(torch.int32)
        last = cur_obj
        status = new_status
        iters = iters + active.to(torch.int32)

    status = torch.where(status == RUNNING, ITER_LIMIT, status).to(torch.int32)
    z = _nonbasic_values(at_upper, in_basis, lo, hi, fin_lo, fin_hi)
    z = z.scatter(1, basis, xB)
    obj = _seq_sum(c * z)
    return LPOutcome(
        status,
        obj,
        z[:, :n],
        basis.to(torch.int32),
        at_upper.to(torch.int32),
        iters,
    )

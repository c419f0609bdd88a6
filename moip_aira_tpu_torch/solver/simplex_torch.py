"""Batched bounded-variable primal simplex in plain PyTorch.

The plain version of K1, the dense-tableau kernel (the JAX package's
``solver/pallas_lp.py::make_pallas_lp_batch``; the CUDA kernel is
``csrc/dense_simplex.cu``).  It computes what that kernel computes, lane by
lane:

* a cold lane starts from the logical basis (tableau ``T = -W``); a warm lane
  (``wb[:, 0] >= 0``) rebuilds ``T = B^-1 W`` for its basis by Gauss-Jordan
  with greedy partial pivoting, and falls back to the cold start when that
  basis turns out singular;
* composite phase 1, Dantzig pricing that becomes Bland's rule after
  ``STALL_LIMIT`` pivots without progress, a ratio test with bound flips and a
  largest-|pivot| tie-break, and a rank-1 tableau update.

The batch is written out by hand: every lane runs the same loop, masked by
its status, until no lane is RUNNING (a data-dependent trip count, which
``torch.func.vmap`` cannot batch).  Ties break as ``torch.argmax`` does, on
the first of equal maxima, which is what the reference's ``jnp.argmax`` does.
Every sum is taken term by term in index order (``_seq_sum``), as the CUDA
kernel takes it, so the two agree bit for bit on any device instead of
drifting apart with each backend's reduction order.

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


def _warm_rebuild(T, wb, warm, n):
    """Gauss-Jordan from ``T = W`` to ``B^-1 W`` for each warm lane's basis.

    The basis-to-row correspondence is free, so each step pivots on the
    (unassigned row, remaining basis column) entry of largest |T|; the first
    such entry in row-major order wins ties.  Returns (T, basis, ok) with ok
    False for lanes whose basis was singular (or that were cold)."""
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
        good = piv.abs() > GJ_PIVOT_TOL
        act = ok & good
        a = act.nonzero().squeeze(1)
        if a.numel():
            ra, ca, pa = r[a], cb[a], piv[a]
            rowdiv = T[a, ra] / pa[:, None]
            colv = T[a, :, ca].clone()
            colv[torch.arange(a.numel(), device=T.device), ra] = pa - 1.0
            T[a] = T[a] - colv[:, :, None] * rowdiv[:, None, :]
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
        nonbasic = ~in_basis
        can_up = nonbasic & (~at_upper | free) & (d < -cost_tol)
        can_dn = nonbasic & (at_upper | free) & (d > cost_tol)
        elig = can_up | can_dn
        any_elig = elig.any(1)
        bland = stall >= STALL_LIMIT
        score = torch.where(
            bland[:, None],
            torch.where(elig, neg_col, -BIG),
            torch.where(elig, d.abs(), -1.0),
        )
        q = score.argmax(1)
        sigma = torch.where(can_up[lanes, q], 1.0, -1.0).to(dtype)
        alpha = T[lanes, :, q]  # (B, m) entering column
        eta = -sigma[:, None] * alpha

        # ---- ratio test ----------------------------------------------------
        lo_q, hi_q = lo[lanes, q], hi[lanes, q]
        flo_q, fhi_q = fin_lo[lanes, q], fin_hi[lanes, q]
        lo_q0 = torch.where(flo_q, lo_q, 0.0)
        hi_q0 = torch.where(fhi_q, hi_q, 0.0)
        flip_theta = torch.where(flo_q & fhi_q, hi_q0 - lo_q0, inf)

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
        hits_up = c2 | c4
        ratios = ratios.clamp_min(0.0)

        rmin = ratios.amin(1)
        tied = ratios <= rmin[:, None] + feas_tol
        pick = torch.where(
            bland[:, None],
            torch.where(tied, -basis.to(dtype), -BIG),
            torch.where(tied, eta.abs(), -1.0),
        )
        r = pick.argmax(1)
        row_blocks = rmin < flip_theta
        theta = torch.where(row_blocks, ratios[lanes, r], flip_theta)
        unbounded = ~torch.isfinite(theta)

        new_status = torch.where(
            ~any_elig,
            torch.where(phase1, INFEASIBLE, OPTIMAL),
            torch.where(
                unbounded, torch.where(phase1, INFEASIBLE, UNBOUNDED), RUNNING
            ),
        ).to(torch.int32)
        new_status = torch.where(active, new_status, status)
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
            rowdiv = T[p, rp] / safe_piv[:, None]
            colv = alpha[p].clone()
            colv[torch.arange(p.numel(), device=dev), rp] = piv - 1.0
            T[p] = T[p] - colv[:, :, None] * rowdiv[:, None, :]
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

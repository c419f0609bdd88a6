"""Batched branch-and-bound fragments in plain PyTorch: the plain version of
K3.

K3 is the JAX package's ``solver/pallas_bb.py::make_pallas_bb_batch``; the
CUDA kernel is ``csrc/bb_fragment.cu`` and its wrapper
``solver/cuda_bb.py``.  Each lane walks a depth-first B&B subtree of up to F
nodes from its root box, solving every node's LP relaxation with K2's
revised simplex (``simplex_torch.revised_lp_batch_ref``'s helpers) and
carrying the basis inverse from node to node.  Per tick a lane does, in this
order:

1. restart: a lane on a fresh node recomputes its basic solution
   xB = -B^-1 (W z_N) from the node's bounds (an empty box is infeasible);
2. one pivot of the node LP: K2's pricing (Bland's rule after STALL_LIMIT
   pivots without progress), ratio test, bound flips and rank-1 update of
   B^-1; the noise-stall exit claims OPTIMAL after
   ``min(STALL_EXIT, max(60, node_iters // 2))`` phase-2 pivots without
   progress, the phase-1 stall exit and the per-node cap ``node_iters``
   claim ITERATION_LIMIT;
3. the node transition when the LP ended: the node's record (status,
   objective, branching column, floor, direction, action, pivots, phase 1)
   at index ``nlog``, then prune against the incumbent, leaf adoption into
   ``best``/``bestx``, or a branch on the most fractional basic integer
   column (lowest row on ties) that pushes the stack and descends into the
   nearer child; the lane stops when ``nlog`` reaches its budget;
4. one backtrack pop: restore a finished entry's bounds, or switch an
   entry to its second child.

A lane ends when its stack is empty (LS_EXHAUSTED), its budget is spent
(LS_BUDGET) or after ``max_ticks`` ticks (LS_TICKS).  The lanes never
interact, so each runs its own tick loop; here they run together, masked
by mode, and ``ticks`` counts each lane's own ticks.

Every dot product is summed term by term in index order with each product
and each sum rounded on its own, as the kernel sums it, so the two agree bit
for bit.  The products by a nonbasic value z_N (W z_N and c . z_N) leave out
the columns whose value is 0 on every lane: W and c are finite, so such a
term adds +-0 and changes no value.

Inputs use the unpadded column layout ``[x | logicals]`` of the LP kernels:
``W`` (m, nc), ``int_mask`` (n or nc) marks the integer structural columns,
``c``/``lo``/``hi`` (B, nc) f32 with +-inf bounds, ``par`` (B, 4) =
[incumbent, objective-integral flag, node budget <= F, lane active flag],
``wb`` (B, m) a warm root basis (-1 = cold) and ``wa`` (B, nc) its at-upper
flags.  The node records' at-upper flags are packed 32 columns to an int32
word (bit b of word w is column 32 w + b).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from moip_aira_tpu_torch.solver.simplex_torch import (
    BIG,
    INFEASIBLE,
    ITER_LIMIT,
    OPTIMAL,
    PIVOT_FLOOR,
    RUNNING,
    STALL_LIMIT,
    UNBOUNDED,
    _big_to_inf,
    _col_sums,
    _entering,
    _rank1,
    _ratio_test,
    _rev_warm_rebuild,
    _row_sums,
    _seq_sum,
    _step_status,
)
from moip_aira_tpu_torch.utils import knobs

STALL_EXIT = 300  # zero-progress phase-2 pivots before claiming OPTIMAL
INT_TOL = 1e-4  # f32 integrality tolerance (the audit re-checks in f64)

# node actions (logged)
ACT_BRANCH = 0
ACT_PRUNE = 1
ACT_INFEAS = 2
ACT_LEAF = 3
ACT_ITERLIM = 4

# lane modes
MODE_PIVOT = 0
MODE_TRANS = 1
MODE_BACK = 2
MODE_DONE = 3

# lane exit states
LS_EXHAUSTED = 0
LS_BUDGET = 1
LS_TICKS = 3

# log scalar-row field indices (lg_scal[:, f, FIELD])
F_STATUS = 0
F_OBJ = 1
F_J = 2
F_FL = 3
F_DIR = 4  # 1 = down child first
F_ACTION = 5
F_ITERS = 6
F_PHASE1 = 7  # 1 = the lane was still primal-infeasible when it closed
N_FIELDS = 8

#: columns per packed at-upper word
PACK = 32


class FragmentOutcome(NamedTuple):
    best: torch.Tensor  # (B,) f32 best incumbent value found (<= par[:, 0])
    bestx: torch.Tensor  # (B, nc) f32 its solution (valid where best improved)
    nlog: torch.Tensor  # (B,) i32 nodes logged
    lstate: torch.Tensor  # (B,) i32 LS_* exit state
    iters: torch.Tensor  # (B,) i32 simplex iterations over all nodes
    ticks: torch.Tensor  # (B,) i32 the lane's ticks
    lg_scal: torch.Tensor  # (B, F, 8) f32 per-node scalars (F_* fields)
    lg_basis: torch.Tensor  # (B, F, m) i32 per-node basis
    lg_atup: torch.Tensor  # (B, F, PW) i32 per-node packed at-upper flags
    fin_basis: torch.Tensor  # (B, m) i32 the basis the lane stopped with
    fin_atup: torch.Tensor  # (B, PW) i32 its packed at-upper flags


def packed_words(nc: int) -> int:
    """int32 words of one packed at-upper row of ``nc`` columns."""
    return -(-nc // PACK)


def stall_exits(node_iters: int, p1_stall: Optional[int] = None):
    """(noise-stall exit, phase-1 stall exit) for a per-node cap
    ``node_iters``: the noise-stall exit is reachable before the cap
    (``min(STALL_EXIT, max(60, node_iters // 2))``), and the phase-1 exit
    defaults to it (``MOIP_FRAG_P1_STALL``; 0 turns it off)."""
    stall_exit = min(STALL_EXIT, max(60, node_iters // 2))
    if p1_stall is None:
        p1_stall = int(knobs.get("MOIP_FRAG_P1_STALL", str(stall_exit)))
    return stall_exit, int(p1_stall)


def pack_atup(atup: torch.Tensor) -> torch.Tensor:
    """(..., nc) 0/1 flags -> (..., PW) int32 words, bit b of word w being
    column 32 w + b."""
    nc = atup.shape[-1]
    pw = packed_words(nc)
    bits = torch.zeros(*atup.shape[:-1], pw * PACK, dtype=torch.int64, device=atup.device)
    bits[..., :nc] = atup.to(torch.int64)
    shifts = torch.arange(PACK, dtype=torch.int64, device=atup.device)
    words = (bits.reshape(*atup.shape[:-1], pw, PACK) << shifts).sum(-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def unpack_atup_np(words, nc: int) -> np.ndarray:
    """(..., PW) packed int32 words -> (..., nc) 0/1 int8."""
    w = np.asarray(words).astype(np.int64) & 0xFFFFFFFF
    cols = np.arange(nc)
    bits = (w[..., cols // PACK] >> (cols % PACK)) & 1
    return np.ascontiguousarray(bits, dtype=np.int8)


def _matvec_nonzero(M, v):
    """``out[..., i] = sum_k M[i, k] * v[..., k]`` term by term in index
    order k, over the k where some lane's v is non-zero (M finite, so the
    other terms add +-0)."""
    acc = torch.zeros(v.shape[0], M.shape[0], dtype=v.dtype, device=v.device)
    for k in torch.nonzero((v != 0).any(0)).flatten().tolist():
        acc = acc + M[:, k] * v[:, k, None]
    return acc


def _dot_nonzero(a, v):
    """``sum_k a[..., k] * v[..., k]`` term by term in index order, over the
    k where some lane's product is non-zero (a and v finite)."""
    prod = a * v
    acc = torch.zeros_like(prod[:, 0])
    for k in torch.nonzero((prod != 0).any(0)).flatten().tolist():
        acc = acc + prod[:, k]
    return acc


def fragment_batch_ref(
    W: torch.Tensor,
    int_mask,
    c: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    par: torch.Tensor,
    wb: torch.Tensor,
    wa: torch.Tensor,
    *,
    F: int = 32,
    D: int = 128,
    node_iters: int = 1500,
    max_ticks: int = 8192,
    feas_tol: float = 3e-4,
    cost_tol: float = 3e-5,
    pivot_tol: float = 3e-5,
    p1_stall: Optional[int] = None,
) -> FragmentOutcome:
    """Run every lane's B&B fragment (see the module docstring); all
    arithmetic in float32 on the device of ``c``."""
    dev = c.device
    f32 = torch.float32
    W = W.to(device=dev, dtype=f32)
    c = c.to(f32)
    clo = lo.to(f32).clone()
    chi = hi.to(f32).clone()
    par = par.to(device=dev, dtype=f32)
    wb = wb.to(dev)
    B, nc = c.shape
    m = W.shape[0]
    n = nc - m
    if W.shape[1] != nc or wb.shape != (B, m) or wa.shape != (B, nc) or par.shape != (B, 4):
        raise ValueError(
            f"shapes W{tuple(W.shape)} c{tuple(c.shape)} par{tuple(par.shape)} "
            f"wb{tuple(wb.shape)} wa{tuple(wa.shape)} do not agree"
        )
    stall_exit, p1_stall = stall_exits(node_iters, p1_stall)
    im = torch.as_tensor(np.asarray(int_mask, dtype=np.float32)).to(dev)
    intm = torch.zeros(nc, dtype=f32, device=dev)
    intm[: min(n, im.shape[0])] = im[:n]  # logical columns are never integral
    lanes = torch.arange(B, device=dev)
    col = torch.arange(nc, device=dev)
    neg_col = -col.to(f32)
    inf = torch.tensor(float("inf"), dtype=f32, device=dev)
    i32 = torch.int32

    # ---- init: the root basis (warm by K2's Gauss-Jordan rebuild) ----------
    warm = wb[:, 0] >= 0
    basis = (n + torch.arange(m, device=dev)).expand(B, m).clone()
    BI = -torch.eye(m, dtype=f32, device=dev).expand(B, m, m).clone()
    use_warm = torch.zeros_like(warm)
    if bool(warm.any()):
        BI_w, basis_w, ok = _rev_warm_rebuild(W, wb, warm)
        use_warm = warm & ok
        BI = torch.where(use_warm[:, None, None], BI_w, BI)
        basis = torch.where(use_warm[:, None], basis_w, basis)
    inb = torch.zeros(B, nc, dtype=torch.bool, device=dev)
    inb.scatter_(1, basis, True)
    fin_lo = torch.isfinite(clo)
    fin_hi = torch.isfinite(chi)
    at0 = (col < n) & ~fin_lo & fin_hi
    atup = torch.where(use_warm[:, None], (wa.to(dev) > 0) & ~inb, at0 & ~inb)
    lo_s = torch.where(fin_lo, clo, torch.where(clo > 0, BIG, -BIG))
    hi_s = torch.where(fin_hi, chi, torch.where(chi > 0, BIG, -BIG))
    bl = _big_to_inf(lo_s.gather(1, basis), lower=True, at=BIG)
    bh = _big_to_inf(hi_s.gather(1, basis), lower=False, at=BIG)
    cB = c.gather(1, basis)
    cIb = intm.expand(B, nc).gather(1, basis)
    xB = torch.zeros(B, m, dtype=f32, device=dev)

    active = par[:, 3] > 0.5
    obj_int = par[:, 1] > 0.5
    budget = par[:, 2]
    best = par[:, 0].clone()
    # both scalars on the lanes' card: torch.where with CPU scalar tensors
    # runs on the current card, which need not be theirs
    eps_l = torch.where(
        obj_int, torch.tensor(1e-6, dtype=f32, device=dev), torch.tensor(1e-9, dtype=f32, device=dev)
    )
    bestx = torch.zeros(B, nc, dtype=f32, device=dev)
    zero_i = torch.zeros(B, dtype=i32, device=dev)
    ncnt, depth, stall, niter, titer, ticks = (zero_i.clone() for _ in range(6))
    lobj = torch.full((B,), float("inf"), dtype=f32, device=dev)
    lpstat = torch.full((B,), RUNNING, dtype=i32, device=dev)
    mode = torch.where(active, MODE_PIVOT, MODE_DONE).to(i32)
    lstate = torch.where(active, LS_TICKS, LS_EXHAUSTED).to(i32)
    restart = active.clone()
    st_j = torch.zeros(B, D, dtype=torch.long, device=dev)
    st_fl = torch.zeros(B, D, dtype=f32, device=dev)
    st_ol = torch.zeros(B, D, dtype=f32, device=dev)
    st_oh = torch.zeros(B, D, dtype=f32, device=dev)
    st_state = torch.zeros(B, D, dtype=torch.bool, device=dev)
    st_dir = torch.zeros(B, D, dtype=torch.bool, device=dev)
    lg_scal = torch.zeros(B, F, N_FIELDS, dtype=f32, device=dev)
    lg_basis = torch.zeros(B, F, m, dtype=i32, device=dev)
    lg_atup = torch.zeros(B, F, packed_words(nc), dtype=i32, device=dev)

    def zv_now():
        """Nonbasic values from the current bounds and at-upper flags."""
        flo, fhi = torch.isfinite(clo), torch.isfinite(chi)
        base = torch.where(flo, clo, torch.where(fhi, chi, torch.zeros_like(clo)))
        zv = torch.where(atup & fhi, chi, base)
        return torch.where(inb, torch.zeros_like(zv), zv)

    def set_var_bounds(sel, j, new_lo, new_hi):
        """Bounds of column j[l] on the lanes ``sel``, and their basic-row
        mirrors."""
        s = torch.nonzero(sel).flatten()
        if s.numel() == 0:
            return
        clo[s, j[s]] = new_lo[s]
        chi[s, j[s]] = new_hi[s]
        rows = sel[:, None] & (basis == j[:, None])
        bl.copy_(torch.where(rows, new_lo[:, None], bl))
        bh.copy_(torch.where(rows, new_hi[:, None], bh))

    for _ in range(max_ticks):
        live = mode != MODE_DONE
        if not bool(live.any()):
            break
        ticks += live.to(i32)

        # ---- 1. restart: the LP of a fresh node ----------------------------
        if bool(restart.any()):
            rs = restart
            xBn = -_row_sums(BI, _matvec_nonzero(W, zv_now()))
            xB = torch.where(rs[:, None], xBn, xB)
            emp = (clo > chi + feas_tol).any(1)
            lpstat = torch.where(rs, torch.where(emp, INFEASIBLE, RUNNING), lpstat).to(i32)
            mode = torch.where(rs, torch.where(emp, MODE_TRANS, MODE_PIVOT), mode).to(i32)
            niter = torch.where(rs, 0, niter).to(i32)
            stall = torch.where(rs, 0, stall).to(i32)
            lobj = torch.where(rs, inf, lobj)
            restart = torch.zeros_like(restart)

        # ---- 2. one simplex pivot for PIVOT lanes ---------------------------
        below = xB < bl - feas_tol
        above = xB > bh + feas_tol
        infeas = torch.where(below, bl - xB, 0.0) + torch.where(above, xB - bh, 0.0)
        infeas_sum = _seq_sum(infeas)
        phase1 = infeas_sum > feas_tol
        stepping0 = (mode == MODE_PIVOT) & (lpstat == RUNNING)
        if bool(stepping0.any()):
            fin_lo = torch.isfinite(clo)
            fin_hi = torch.isfinite(chi)
            free = ~fin_lo & ~fin_hi
            cB_eff = torch.where(
                phase1[:, None],
                torch.where(below, -1.0, torch.where(above, 1.0, 0.0)).to(f32),
                cB,
            )
            d = -_col_sums(W, _col_sums(BI, cB_eff))
            d = torch.where(phase1[:, None], d, d + c)
            bland = stall >= STALL_LIMIT
            q, can_up, any_elig = _entering(d, inb, atup, free, bland, cost_tol, neg_col)
            sigma = torch.where(can_up[lanes, q], 1.0, -1.0).to(f32)
            alpha = _row_sums(BI, W[:, q].T)  # B^-1 W[:, q]
            eta = -sigma[:, None] * alpha
            lo_q, hi_q = clo[lanes, q], chi[lanes, q]
            flo_q, fhi_q = fin_lo[lanes, q], fin_hi[lanes, q]
            lo_q0 = torch.where(flo_q, lo_q, 0.0)
            hi_q0 = torch.where(fhi_q, hi_q, 0.0)
            flip_theta = torch.where(flo_q & fhi_q, hi_q0 - lo_q0, inf)
            ratios, hits_up, rmin, r = _ratio_test(
                xB, bl, bh, below, above, eta, basis, bland, feas_tol, pivot_tol
            )
            row_blocks = rmin < flip_theta
            theta = torch.where(row_blocks, ratios[lanes, r], flip_theta)
            lp_new = _step_status(any_elig, theta, phase1, stepping0, lpstat)
            stepping = stepping0 & (lp_new == RUNNING)
            do_pivot = stepping & row_blocks
            do_flip = stepping & ~row_blocks

            atq = atup[lanes, q]
            f = torch.nonzero(do_flip).flatten()
            atup[f, q[f]] = ~atq[f]
            zq = torch.where(atq, hi_q0, lo_q0)
            zq = torch.where(flo_q | fhi_q, zq, 0.0)
            xb_step = xB + eta * theta[:, None]
            moved = (do_pivot | do_flip)[:, None]
            p = torch.nonzero(do_pivot).flatten()
            if p.numel():
                rp, qp = r[p], q[p]
                piv = alpha[p, rp]
                safe_piv = torch.where(piv.abs() > PIVOT_FLOOR, piv, 1.0)
                BI[p] = _rank1(BI[p], rp, alpha[p], piv, safe_piv)
                p_col = basis[p, rp]
                atup[p, p_col] = hits_up[p, rp]
                inb[p, p_col] = False
                inb[p, qp] = True
                xb_step[p, rp] = zq[p] + sigma[p] * theta[p]
                basis[p, rp] = qp
                bl[p, rp] = _big_to_inf(
                    torch.where(fin_lo[p, qp], clo[p, qp], -BIG), lower=True, at=BIG / 2
                )
                bh[p, rp] = _big_to_inf(
                    torch.where(fin_hi[p, qp], chi[p, qp], BIG), lower=False, at=BIG / 2
                )
                cB[p, rp] = c[p, qp]
                cIb[p, rp] = intm[qp]
            xB = torch.where(moved, xb_step, xB)

            cur_obj = torch.where(phase1, infeas_sum, _seq_sum(cB * xB))
            progressed = cur_obj < lobj - 1e-9
            stall = torch.where(stepping0, torch.where(progressed, 0, stall + 1), stall).to(i32)
            lobj = torch.where(stepping0, cur_obj, lobj)
            niter = niter + stepping0.to(i32)
            titer = titer + stepping0.to(i32)
            running = (lp_new == RUNNING) & stepping0
            # noise-stall exit: hundreds of phase-2 pivots without progress
            # sit on the optimal face; claim OPTIMAL for the audit to check
            lp_new = torch.where(running & ~phase1 & (stall >= stall_exit), OPTIMAL, lp_new)
            if p1_stall > 0:
                running = (lp_new == RUNNING) & stepping0
                lp_new = torch.where(running & phase1 & (stall >= p1_stall), ITER_LIMIT, lp_new)
            running = (lp_new == RUNNING) & stepping0
            lp_new = torch.where(running & (niter >= node_iters), ITER_LIMIT, lp_new)
            lpstat = torch.where(stepping0, lp_new, lpstat).to(i32)
            mode = torch.where(stepping0 & (lp_new != RUNNING), MODE_TRANS, mode).to(i32)

        # ---- 3. node transition for TRANS lanes ------------------------------
        tr = mode == MODE_TRANS
        if bool(tr.any()):
            zv = zv_now()
            objv = _seq_sum(cB * xB) + _dot_nonzero(c, zv)
            lst = torch.where(lpstat == UNBOUNDED, ITER_LIMIT, lpstat).to(i32)
            bnd = torch.where(obj_int, torch.ceil(objv - INT_TOL), objv)
            frv = (xB - torch.round(xB)).abs() * cIb
            rstar = frv.argmax(1)
            frmax = frv[lanes, rstar]
            jbr = basis[lanes, rstar]
            xval = xB[lanes, rstar]
            fl = torch.floor(xval + INT_TOL)
            act = torch.where(
                lst == INFEASIBLE,
                ACT_INFEAS,
                torch.where(
                    lst == ITER_LIMIT,
                    ACT_ITERLIM,
                    torch.where(
                        bnd >= best - eps_l,
                        ACT_PRUNE,
                        torch.where(frmax <= INT_TOL, ACT_LEAF, ACT_BRANCH),
                    ),
                ),
            ).to(i32)
            # depth-limited branches: the host re-opens the node
            act = torch.where((act == ACT_BRANCH) & (depth >= D - 1), ACT_ITERLIM, act)
            down_first = (xval - fl) <= 0.5

            # ---- the record at index ncnt ------------------------------------
            w = torch.nonzero(tr & (ncnt < F)).flatten()
            if w.numel():
                fw = ncnt[w].long()
                rec = torch.stack(
                    [
                        lst.to(f32), objv, jbr.to(f32), fl, down_first.to(f32),
                        act.to(f32), niter.to(f32), phase1.to(f32),
                    ],
                    dim=1,
                )
                lg_scal[w, fw] = rec[w]
                lg_basis[w, fw] = basis[w].to(i32)
                lg_atup[w, fw] = pack_atup(atup[w])
            ncnt = ncnt + tr.to(i32)

            # ---- leaf adoption -------------------------------------------
            adopt = tr & (act == ACT_LEAF) & (objv < best - eps_l)
            a = torch.nonzero(adopt).flatten()
            if a.numel():
                z = zv[a].clone()
                z[torch.arange(a.numel(), device=dev)[:, None], basis[a]] = xB[a]
                bestx[a] = z
                best = torch.where(adopt, objv, best)

            # ---- descend on branch: push, first child's bounds -----------
            br = tr & (act == ACT_BRANCH)
            if bool(br.any()):
                s = torch.nonzero(br).flatten()
                jold_lo = clo[lanes, jbr]
                jold_hi = chi[lanes, jbr]
                ds = depth[s].long()
                st_j[s, ds] = jbr[s]
                st_fl[s, ds] = fl[s]
                st_ol[s, ds] = jold_lo[s]
                st_oh[s, ds] = jold_hi[s]
                st_state[s, ds] = False
                st_dir[s, ds] = down_first[s]
                # first child: down => x_j <= fl ; up => x_j >= fl + 1
                nlo = torch.where(down_first, jold_lo, fl + 1.0)
                nhi = torch.where(down_first, fl, jold_hi)
                set_var_bounds(br, jbr, nlo, nhi)
                depth = depth + br.to(i32)

            # ---- mode hand-off -------------------------------------------
            hit_budget = ncnt.to(f32) >= budget
            new_mode = torch.where(
                hit_budget, MODE_DONE, torch.where(br, MODE_PIVOT, MODE_BACK)
            )
            lstate = torch.where(tr & hit_budget, LS_BUDGET, lstate).to(i32)
            restart = restart | (br & ~hit_budget)
            mode = torch.where(tr, new_mode, mode).to(i32)

        # ---- 4. one backtrack pop for BACK lanes -------------------------------
        bk = mode == MODE_BACK
        if bool(bk.any()):
            emptyst = bk & (depth == 0)
            mode = torch.where(emptyst, MODE_DONE, mode).to(i32)
            lstate = torch.where(emptyst, LS_EXHAUSTED, lstate).to(i32)
            bk = bk & (depth > 0)
            if bool(bk.any()):
                top = (depth - 1).clamp_min(0).long()
                ej = st_j[lanes, top]
                efl = st_fl[lanes, top]
                eol = st_ol[lanes, top]
                eoh = st_oh[lanes, top]
                est = st_state[lanes, top]
                edir = st_dir[lanes, top]
                second_done = bk & est
                to_sib = bk & ~est
                # both children done: restore and pop
                set_var_bounds(second_done, ej, eol, eoh)
                depth = depth - second_done.to(i32)
                # switch to the sibling: down first => up [fl+1, old_hi],
                # up first => down [old_lo, fl]
                slo = torch.where(edir, efl + 1.0, eol)
                shi = torch.where(edir, eoh, efl)
                set_var_bounds(to_sib, ej, slo, shi)
                t = torch.nonzero(to_sib).flatten()
                st_state[t, top[t]] = True
                restart = restart | to_sib
                mode = torch.where(to_sib, MODE_PIVOT, mode).to(i32)

    return FragmentOutcome(
        best=best,
        bestx=bestx,
        nlog=ncnt,
        lstate=lstate,
        iters=titer,
        ticks=ticks,
        lg_scal=lg_scal,
        lg_basis=lg_basis,
        lg_atup=lg_atup,
        fin_basis=basis.to(i32),
        fin_atup=pack_atup(atup),
    )

"""K2's launch plan and its cluster-wide pricing rule, on the CPU.

``rev_launch_plan`` (solver/cuda_lp.py) picks, per launch, how many blocks
of a cluster share one LP and what each block keeps in shared memory; the
kernel (csrc/revised_simplex.cu) only checks the plan.  The kernel's pricing
picks the entering column in two levels: each block's best column of its
slice, then the best of the blocks' winners, each comparison by
``beats`` (larger score, then lower column), each reduction a warp tree.
Here a model of those reductions is held against the plain version's
``simplex_torch._entering`` (one arg-max over the whole row) on adversarial
reduced costs.  The kernel itself runs on the card: tests/test_torch_cuda.py.
"""

import os

import numpy as np
import pytest
import torch

from moip_aira_tpu_torch.io import read_problem
from moip_aira_tpu_torch.solver import simplex_torch as st
from moip_aira_tpu_torch.solver.cuda_lp import (
    REV_MAX_CLUSTER,
    REV_MAX_THREADS,
    STATIC_SMEM_RESERVE,
    RevPlan,
    make_cuda_rev_batch,
    rev_launch_plan,
    rev_smem_bytes,
)

EX = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
H100_SMEM = 232_448  # shared bytes an H100 block may opt into
H100_SMS = 132
#: clusters of C blocks an H100 holds at once under K2's plans, as
#: cudaOccupancyMaxActiveClusters reported them (PERF.md §6)
H100_HELD = {1: 132, 2: 66, 4: 30, 8: 15}
COST_TOL = 3e-5


def shape(name):
    p = read_problem(os.path.join(EX, f"{name}.lp"))
    return p.m_total, p.n


@pytest.mark.parametrize("name", ["G2AP05", "2AP20", "2AP40", "2AP100"])
@pytest.mark.parametrize("lanes", [1, 8, 64, 256])
def test_launch_plan_covers_every_column_once_and_fits(name, lanes):
    m, n = shape(name)
    nc = n + m
    plan = rev_launch_plan(m, n, lanes, H100_SMEM, H100_SMS, H100_HELD)
    cols = np.concatenate([np.arange(a, b) for a, b in plan.slices])
    assert np.array_equal(cols, np.arange(nc))
    assert all(b - a >= 1 for a, b in plan.slices)
    assert plan.smem_bytes <= H100_SMEM - STATIC_SMEM_RESERVE
    assert plan.C in (1, 2, 4, 8) and plan.C <= REV_MAX_CLUSTER
    assert lanes <= H100_HELD[plan.C] or plan.C == 1
    assert plan.threads % 32 == 0 and plan.threads <= REV_MAX_THREADS
    assert plan.threads >= min(REV_MAX_THREADS, plan.width, 32 * (-(-m // 32)))
    # B^-1 first, then the W slice, then P1
    assert plan.bi_smem or not (plan.w_smem or plan.p1_smem)


def test_launch_plan_by_shape_and_lanes():
    """The smallest cluster whose W slices fit in shared memory while the
    card holds a cluster for every lane; else the largest size at which it
    still holds them all (30 clusters of 4, 15 of 8 on the H100)."""
    m, n = shape("2AP40")  # the slice fits from four blocks on (138 KB)
    got = [rev_launch_plan(m, n, L, H100_SMEM, H100_SMS, H100_HELD)
           for L in (1, 8, 30, 31, 33, 34, 64, 66, 67, 256)]
    assert [p.C for p in got] == [4, 4, 4, 2, 2, 2, 2, 2, 1, 1]
    assert [p.layout for p in got[:5]] == ["B^-1+W+P1"] * 3 + ["B^-1+P1"] * 2
    m, n = shape("2AP100")  # B^-1 alone is 163 KB: the slice never fits
    got = [rev_launch_plan(m, n, L, H100_SMEM, H100_SMS, H100_HELD)
           for L in (1, 15, 16, 17, 30, 31, 64, 66, 67, 256)]
    assert [p.C for p in got] == [8, 8, 4, 4, 4, 2, 2, 2, 1, 1]
    assert {p.layout for p in got} == {"B^-1"}
    for name in ("2AP20", "G2AP05"):  # W fits whole: one block a lane
        m, n = shape(name)
        assert rev_launch_plan(m, n, 1, H100_SMEM, H100_SMS, H100_HELD).C == 1
    with pytest.raises(ValueError):
        rev_launch_plan(4000, 60000, 1, H100_SMEM, H100_SMS, H100_HELD)


def test_smem_bytes_by_part():
    m, nc = 82, 1682
    base = rev_smem_bytes(m, nc, 8, False, False, False)
    assert base % 16 == 0
    assert rev_smem_bytes(m, nc, 8, False, True, True) - base == 2 * 4 * m * m
    assert rev_smem_bytes(m, nc, 8, True, False, False) - base == 4 * m * 211
    assert RevPlan(m, nc, 4, 512, True, True, True).smem_bytes == rev_smem_bytes(
        m, nc, 4, True, True, True
    )


# ---- the two-level arg-max --------------------------------------------------


def beats(a, ia, b, ib):
    return a > b or (a == b and ia < ib)


NONE = (float("-inf"), 2**31 - 1)


def warp_tree(vals):
    """revised_core.cuh's warp reduction: shfl_down by 16, 8, ..., 1 (a lane
    past the warp reads its own value), lane 0's result."""
    v = list(vals) + [NONE] * (32 - len(vals))
    for off in (16, 8, 4, 2, 1):
        nxt = list(v)
        for lane in range(32):
            o = v[lane + off] if lane + off < 32 else v[lane]
            if beats(o[0], o[1], v[lane][0], v[lane][1]):
                nxt[lane] = o
        v = nxt
    return v[0]


def kernel_entering(score, C, threads):
    """The entering column as the kernel picks it: each thread's best of its
    columns tid, tid + threads, ... of its block's slice; each warp's tree;
    the tree over the block's warps; the tree over the cluster's blocks."""
    nc = score.shape[0]
    width = -(-nc // C)
    blocks = []
    for r in range(C):
        j0, j1 = min(nc, r * width), min(nc, r * width + width)
        best = [NONE] * threads
        for j in range(j0, j1):
            t = (j - j0) % threads
            if beats(float(score[j]), j, *best[t]):
                best[t] = (float(score[j]), j)
        warps = [warp_tree(best[w * 32 : w * 32 + 32]) for w in range(threads // 32)]
        blocks.append(warp_tree(warps))
    return warp_tree(blocks)[1]


def scores(d, in_basis, at_upper, free, bland):
    """The kernel's pricing score of every column (rev_price_cols)."""
    nb = ~in_basis
    el = nb & (((~at_upper | free) & (d < -COST_TOL)) | ((at_upper | free) & (d > COST_TOL)))
    j = np.arange(d.shape[0], dtype=np.float32)
    if bland:
        return np.where(el, -j, np.float32(-st.BIG)).astype(np.float32), el.any()
    return np.where(el, np.abs(d), np.float32(-1.0)).astype(np.float32), el.any()


def tie_columns(nc, width):
    """Both sides of the first two slice boundaries, and the last column."""
    return sorted({j for j in (width - 1, width, 2 * width - 1, 2 * width) if j < nc} | {nc - 1})


def adversarial_d(kind, nc, width, rng):
    d = (rng.standard_normal(nc) * 1e-6).astype(np.float32)  # all ineligible
    if kind == "ties_across_slices":
        # the same |d| at the last column of one slice and the first of the
        # next, and at both ends of the row: the lowest column must win
        d[tie_columns(nc, width)] = -2.5
        d[tie_columns(nc, width)[-1]] = 2.5
    elif kind == "winner_in_last_slice":
        d[nc - 5] = -9.0
        d[5] = 8.999999
    elif kind == "no_eligible":
        pass
    elif kind == "bland_late_slices":
        d[2 * width + 7 :] = -1.0  # eligible only from the third slice on
    elif kind == "random":
        d = (rng.standard_normal(nc) * 3).astype(np.float32)
        d[rng.choice(nc, 40, replace=False)] = np.float32(1.5)
    return d


@pytest.mark.parametrize(
    "kind", ["ties_across_slices", "winner_in_last_slice", "no_eligible", "bland_late_slices", "random"]
)
@pytest.mark.parametrize("bland", [False, True])
def test_two_level_argmax_matches_entering(kind, bland):
    """Every cluster size the plan returns, at 2AP40's width: the kernel's
    two-level pick equals the plain version's one arg-max, in Dantzig and in
    Bland mode, with slices that hold no eligible column."""
    rng = np.random.default_rng(17)
    m, n = shape("2AP40")
    nc = n + m
    in_basis = np.zeros(nc, bool)
    in_basis[rng.choice(nc, m, replace=False)] = True
    at_upper = (rng.random(nc) < 0.2) & ~in_basis
    free = np.zeros(nc, bool)
    free[n + m - 2 :] = True
    for C in (1, 2, 4, 8):
        width = -(-nc // C)
        d = adversarial_d(kind, nc, width, rng)
        in_b = in_basis.copy()
        if kind == "ties_across_slices":
            in_b[tie_columns(nc, width)] = False
        sc, any_el = scores(d, in_b, at_upper, free, bland)
        threads = rev_launch_plan(m, n, 1, H100_SMEM, H100_SMS, H100_HELD).threads if C == 8 else 512
        q_plain, _, any_plain = st._entering(
            torch.as_tensor(d)[None], torch.as_tensor(in_b)[None],
            torch.as_tensor(at_upper)[None], torch.as_tensor(free)[None],
            torch.tensor([bland]), COST_TOL, -torch.arange(nc, dtype=torch.float32),
        )
        assert kernel_entering(sc, C, threads) == int(q_plain[0]), (C, kind)
        assert bool(any_el) == bool(any_plain[0])
        if kind == "no_eligible":
            assert not any_el and int(q_plain[0]) == 0


def test_wrapper_on_the_cpu_runs_the_plain_version_only():
    """On CPU tensors K2's wrapper neither plans nor launches: the plain
    version answers, and no cluster size or launch is counted."""
    p = read_problem(os.path.join(EX, "G2AP05.lp"))
    A_full = np.vstack([p.A, p.C])
    m, n = A_full.shape[0], p.n
    nc = n + m
    W = torch.as_tensor(np.hstack([A_full, -np.eye(m)]), dtype=torch.float32)
    k2 = make_cuda_rev_batch(W, torch.device("cpu"))

    def two(row):
        return torch.as_tensor(np.tile(row, (2, 1)), dtype=torch.float32).contiguous()

    c = two(np.concatenate([p.C[0], np.zeros(m)]))
    lo = two(np.concatenate([p.lb, p.row_lb, [-np.inf] * p.objcnt]))
    hi = two(np.concatenate([p.ub, p.row_ub, [np.inf] * p.objcnt]))
    wb = torch.full((2, m), -1, dtype=torch.int32)
    wa = torch.zeros((2, nc), dtype=torch.int32)
    out = k2(c, lo, hi, wb, wa)
    ref = st.revised_lp_batch_ref(k2.W, c, lo, hi, wb, wa)
    for f in out._fields:
        assert torch.equal(getattr(out, f), getattr(ref, f)), f
    assert (out.status == st.OPTIMAL).all()
    assert k2.launches == 0 and not k2.cluster_sizes
    with pytest.raises(ValueError):
        k2.run(c, lo, hi, wb, wa, rev_launch_plan(m, n, 2, H100_SMEM, H100_SMS, H100_HELD))

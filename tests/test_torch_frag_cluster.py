"""K3's launch plan, K2's plan against the clusters the card holds, and the
bookkeeping K3's cluster kernel changed, on the CPU.

``bb_launch_plan`` (solver/cuda_bb.py) picks, per launch, how many blocks of
a cluster share one B&B subtree and what each block keeps in shared memory;
``rev_launch_plan`` (solver/cuda_lp.py) does the same for K2.  Both read how
many clusters of each size the card holds at once, so that no launch plans
more lanes than the card runs in one round.  The kernel's tick also changed
two sums and one counter without changing a bit: the restart's W z_N and the
node's c . z_N skip the zero terms of z, and the stall counter takes a
phase-2 pivot's objective at the start of the next pivot.  Models of both
are held here against the plain version's arithmetic; the kernel itself runs
on the card (tests/test_torch_cuda.py).
"""

import os

import numpy as np
import pytest
import torch

from moip_aira_tpu_torch.io import read_problem
from moip_aira_tpu_torch.solver import bb_torch
from moip_aira_tpu_torch.solver.cuda_bb import (
    BBPlan,
    bb_launch_plan,
    bb_plan_for,
    bb_scratch_bytes,
    bb_smem_bytes,
    make_cuda_bb_batch,
)
from moip_aira_tpu_torch.solver.cuda_lp import (
    REV_MAX_THREADS,
    STATIC_SMEM_RESERVE,
    cluster_sizes_for,
    rev_launch_plan,
)

EX = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
H100_SMEM = 232_448  # shared bytes an H100 block may opt into
H100_SMS = 132
#: clusters of C blocks the H100 holds at once under K2's plans
#: (cudaOccupancyMaxActiveClusters; PERF.md §6)
H100_HELD = {1: 132, 2: 66, 4: 30, 8: 15}
#: what the plans assumed before they read the card: a cluster for every C
#: SMs
SMS_HELD = {C: H100_SMS // C for C in (1, 2, 4, 8)}
D = 128


def shape(name):
    p = read_problem(os.path.join(EX, f"{name}.lp"))
    return p.m_total, p.n


# ---- K3's plan ----------------------------------------------------------


@pytest.mark.parametrize(
    "name,lanes,C,layout,smem",
    [
        # one block holds all of W beside everything else
        ("G3KP10", 256, 1, "B^-1+W+bounds+P1", 3008),
        ("2AP20", 1, 1, "B^-1+W+bounds+P1", 97200),
        ("2AP20", 256, 1, "B^-1+W+bounds+P1", 97200),
        # a slice of 82 x 421 floats a block from C = 4, with P1 215 KB
        ("2AP40", 1, 4, "B^-1+W+bounds+P1", 215104),
        ("2AP40", 30, 4, "B^-1+W+bounds+P1", 215104),
        # more lanes than clusters of four: two blocks a lane, W from L2
        ("2AP40", 31, 2, "B^-1+bounds+P1", 77024),
        ("2AP40", 66, 2, "B^-1+bounds+P1", 77024),
        ("2AP40", 67, 1, "B^-1+bounds+P1", 77024),
        # B^-1 alone is 163 KB: nothing else fits, W never does
        ("2AP100", 1, 8, "B^-1", 175632),
        ("2AP100", 16, 4, "B^-1", 175632),
        ("2AP100", 64, 2, "B^-1", 175632),
        ("2AP100", 256, 1, "B^-1", 175632),
    ],
)
def test_bb_launch_plan_by_shape(name, lanes, C, layout, smem):
    m, n = shape(name)
    nc = n + m
    plan = bb_launch_plan(m, n, D, lanes, H100_SMEM, H100_SMS, H100_HELD)
    assert (plan.C, plan.layout, plan.smem_bytes) == (C, layout, smem)
    assert plan.smem_bytes <= H100_SMEM - STATIC_SMEM_RESERVE
    cols = np.concatenate([np.arange(a, b) for a, b in plan.slices])
    assert np.array_equal(cols, np.arange(nc))
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= REV_MAX_THREADS
    assert plan.threads >= min(REV_MAX_THREADS, plan.width)
    # B^-1 first; nothing else without it
    assert plan.bi_smem or not (plan.w_smem or plan.col_smem or plan.p1_smem)


def test_bb_plan_order_of_shared_memory():
    """B^-1, then the W slice, then the node bounds and flags, then P1: as
    the room shrinks, P1 leaves first and B^-1 last."""
    m, n = shape("2AP40")
    nc = n + m
    full = bb_plan_for(m, n, D, 4, H100_SMEM)
    assert full.layout == "B^-1+W+bounds+P1"
    room = [full.smem_bytes + STATIC_SMEM_RESERVE - k for k in (0, 16, 4 * m * m, 4 * m * m + 16)]
    got = [bb_plan_for(m, n, D, 4, r).layout for r in room]
    assert got == ["B^-1+W+bounds+P1", "B^-1+W+bounds", "B^-1+W+bounds", "B^-1+W"]
    no_w = bb_plan_for(m, n, D, 4, bb_smem_bytes(m, nc, D, 4, True, False, True, True) + STATIC_SMEM_RESERVE)
    assert no_w.layout == "B^-1+bounds+P1"
    only_bi = bb_smem_bytes(m, nc, D, 4, True, False, False, False) + STATIC_SMEM_RESERVE
    assert bb_plan_for(m, n, D, 4, only_bi).layout == "B^-1"
    assert bb_plan_for(m, n, D, 4, only_bi - 16).layout == "-"
    with pytest.raises(ValueError):
        bb_plan_for(6000, 60000, D, 1, H100_SMEM)  # 284 KB of m-vectors


def test_bb_bytes_by_part():
    m, nc = 82, 1682
    # the m-vectors, the stack and the rebuild's masks, unaligned
    vec = 4 * (10 * m + 3 * D) + 4 * (2 * m + D) + 2 * D + 2 * m

    def round16(b):
        return (b + 15) & ~15

    assert bb_smem_bytes(m, nc, D, 4, False, False, False, False) == round16(vec) == 6416
    assert bb_smem_bytes(m, nc, D, 4, True, False, False, True) == round16(vec + 2 * 4 * m * m)
    assert bb_smem_bytes(m, nc, D, 4, False, True, False, False) == round16(vec + 4 * m * 421)
    assert bb_smem_bytes(m, nc, D, 8, False, True, False, False) == round16(vec + 4 * m * 211)
    assert bb_smem_bytes(m, nc, D, 4, False, False, True, False) == round16(vec + 10 * nc)
    # what leaves shared memory lands in the block's global scratch, beside
    # z and its non-zero columns
    assert bb_scratch_bytes(m, nc, True, True, True) == round16(8 * nc)
    assert bb_scratch_bytes(m, nc, False, False, False) == round16(8 * nc + 2 * 4 * m * m + 10 * nc)
    plan = BBPlan(m, nc, D, 4, 512, True, True, True, False)
    assert plan.smem_bytes == bb_smem_bytes(m, nc, D, 4, True, True, True, False)
    assert plan.scratch_bytes == bb_scratch_bytes(m, nc, True, True, False)


# ---- both plans against the clusters the card holds ----------------------


@pytest.mark.parametrize("name", ["G3KP10", "2AP20", "2AP40", "2AP100"])
@pytest.mark.parametrize("which", ["K2", "K3"])
def test_no_plan_queues_clusters(name, which):
    """With a card that holds 30 clusters of 4 and 15 of 8, no lane count
    gets a C the card cannot hold for every lane at once, unless C = 1; in
    particular 31-33 lanes never take C = 4 and 16 lanes never C = 8."""
    m, n = shape(name)

    def plan(lanes, held):
        if which == "K2":
            return rev_launch_plan(m, n, lanes, H100_SMEM, H100_SMS, held)
        return bb_launch_plan(m, n, D, lanes, H100_SMEM, H100_SMS, held)

    for lanes in range(1, 300):
        C = plan(lanes, H100_HELD).C
        assert C == 1 or lanes <= H100_HELD[C], (lanes, C)
    for lanes in (31, 32, 33):
        assert plan(lanes, H100_HELD).C != 4
    assert plan(16, H100_HELD).C != 8
    # the plan never believes the card holds more than its SMs allow
    assert plan(40, {1: 500, 2: 500, 4: 500, 8: 500}).C in (1, 2)


def test_wide_plans_keep_their_c_where_the_card_holds_them():
    """The 2AP40 wide front's K2 launches: wherever the card holds the
    lanes at the C the old rule (a cluster for every C SMs) picked, the new
    rule picks the same C and layout; only the launches the card could not
    hold at once move."""
    m, n = shape("2AP40")
    moved = []
    for lanes in range(1, 400):
        old = rev_launch_plan(m, n, lanes, H100_SMEM, H100_SMS, SMS_HELD)
        new = rev_launch_plan(m, n, lanes, H100_SMEM, H100_SMS, H100_HELD)
        if old.C == 1 or lanes <= H100_HELD[old.C]:
            assert new == old, lanes
        else:
            moved.append((lanes, old.C, new.C))
    assert moved == [(31, 4, 2), (32, 4, 2), (33, 4, 2)]


def test_cluster_sizes_leave_each_block_a_slice():
    assert cluster_sizes_for(14) == [1]
    assert cluster_sizes_for(442) == [1, 2]
    assert cluster_sizes_for(1682) == [1, 2, 4, 8]


# ---- the tick's arithmetic ------------------------------------------------


def seq_sum32(terms):
    acc = np.float32(0.0)
    for t in terms:
        acc = np.float32(acc + np.float32(t))
    return acc


@pytest.mark.parametrize("seed", range(6))
def test_sums_over_nonzero_columns_equal_the_full_sums(seed):
    """W z_N and c . z_N summed in index order over the columns whose z is
    non-zero equal the full sums bit for bit, signed zeros and cancelling
    terms included: a sum that starts at +0 is never -0."""
    rng = np.random.default_rng(seed)
    m, nc = 9, 300
    W = rng.standard_normal((m, nc)).astype(np.float32)
    W[:, rng.choice(nc, 40, replace=False)] = 0.0
    W[:, rng.choice(nc, 20, replace=False)] = -0.0
    c = rng.integers(-3, 4, nc).astype(np.float32)
    z = np.zeros(nc, np.float32)
    on = rng.choice(nc, 50, replace=False)
    z[on] = rng.choice([1.0, -1.0, 2.5, 0.25], 50).astype(np.float32)
    z[rng.choice(nc, 30, replace=False)] = -0.0
    z[on[:3]] = np.float32(1e-30)  # products that cancel or underflow
    nz = np.flatnonzero(z != 0)
    for j in range(m):
        full = seq_sum32(np.float32(W[j, k] * z[k]) for k in range(nc))
        part = seq_sum32(np.float32(W[j, k] * z[k]) for k in nz)
        assert full.tobytes() == part.tobytes()
    full = seq_sum32(np.float32(c[k] * z[k]) for k in range(nc))
    part = seq_sum32(np.float32(c[k] * z[k]) for k in nz)
    assert full.tobytes() == part.tobytes()
    # the plain version's own skip (columns zero on every lane) agrees
    got = bb_torch._dot_nonzero(torch.as_tensor(c)[None], torch.as_tensor(z)[None])
    assert got.numpy()[0].tobytes() == full.tobytes()


def stall_immediate(pivots, stall_exit, p1_stall, node_iters):
    """The plain version's stall bookkeeping (bb_torch.fragment_batch_ref):
    after each pivot the objective (phase 1: the sum before it; phase 2:
    c_B^T x_B after it) updates the counter, then the exits.  Returns each
    pivot's Bland flag and the status that closes the node."""
    stall, lobj, out = 0, np.float32(np.inf), []
    for k, (phase1, s_before, obj_after, status) in enumerate(pivots):
        out.append(stall >= 60)
        cur = s_before if phase1 else obj_after
        stall = 0 if cur < np.float32(lobj - np.float32(1e-9)) else stall + 1
        lobj = cur
        lp = status
        if lp == -1 and not phase1 and stall >= stall_exit:
            lp = 0
        if p1_stall > 0 and lp == -1 and phase1 and stall >= p1_stall:
            lp = 3
        if lp == -1 and k + 1 >= node_iters:
            lp = 3
        if lp != -1:
            return out, lp, k
    return out, -1, len(pivots) - 1


def stall_deferred(pivots, stall_exit, p1_stall, node_iters):
    """K3's: a phase-2 pivot's objective waits for the next pivot's start
    (rev_pivot_start), unless the noise-stall exit may fire at once."""
    stall, lobj, pend, out = 0, np.float32(np.inf), False, []
    prev_obj = None
    for k, (phase1, s_before, obj_after, status) in enumerate(pivots):
        if pend:
            cur = prev_obj
            stall = 0 if cur < np.float32(lobj - np.float32(1e-9)) else stall + 1
            lobj = cur
        out.append(stall >= 60)
        lp = status
        defer = not phase1 and not (lp == -1 and stall + 1 >= stall_exit)
        if not defer:
            cur = s_before if phase1 else obj_after
            stall = 0 if cur < np.float32(lobj - np.float32(1e-9)) else stall + 1
            lobj = cur
        if lp == -1 and not phase1 and stall >= stall_exit:
            lp = 0
        if p1_stall > 0 and lp == -1 and phase1 and stall >= p1_stall:
            lp = 3
        if lp == -1 and k + 1 >= node_iters:
            lp = 3
        pend = defer and lp == -1
        prev_obj = obj_after
        if lp != -1:
            return out, lp, k
    return out, -1, len(pivots) - 1


@pytest.mark.parametrize("seed", range(8))
def test_deferred_stall_counter_matches_the_plain_version(seed):
    """Over random pivot sequences (phases that switch, long runs without
    progress, LPs that end by status, by either stall exit or by the cap),
    deferring a phase-2 objective to the next pivot gives every pivot the
    same Bland flag and closes the node at the same pivot with the same
    status."""
    rng = np.random.default_rng(seed)
    for _ in range(40):
        n = int(rng.integers(1, 700))
        pivots = []
        obj = np.float32(100.0)
        for k in range(n):
            phase1 = bool(rng.random() < (0.6 if k < n // 3 else 0.05))
            if rng.random() < 0.3:
                obj = np.float32(obj - np.float32(rng.random()))
            status = -1 if rng.random() > 0.002 else int(rng.integers(0, 3))
            pivots.append((phase1, np.float32(rng.random() * 5), obj, status))
        for stall_exit, p1_stall, node_iters in ((300, 300, 1500), (60, 60, 400), (100, 0, 600)):
            a = stall_immediate(pivots, stall_exit, p1_stall, node_iters)
            b = stall_deferred(pivots, stall_exit, p1_stall, node_iters)
            assert a == b


# ---- the wrapper on the CPU ---------------------------------------------


def test_bb_wrapper_on_the_cpu_runs_the_plain_version_only():
    """On CPU tensors K3's wrapper neither plans nor launches: the plain
    version answers, nothing is counted, and a plan is refused."""
    p = read_problem(os.path.join(EX, "G3KP10.lp"))
    A_full = np.vstack([p.A, p.C])
    m, n = A_full.shape[0], p.n
    nc = n + m
    W = torch.as_tensor(np.hstack([A_full, -np.eye(m)]), dtype=torch.float32)
    fn, _ = make_cuda_bb_batch(W, p.is_int, torch.device("cpu"), F=4, node_iters=200)

    def two(row):
        return torch.as_tensor(np.tile(row, (2, 1)), dtype=torch.float32).contiguous()

    c = two(np.concatenate([-p.C[0], np.zeros(m)]))
    lo = two(np.concatenate([p.lb, p.row_lb, [-np.inf] * p.objcnt]))
    hi = two(np.concatenate([p.ub, p.row_ub, [np.inf] * p.objcnt]))
    par = torch.tensor([[np.inf, 1.0, 4.0, 1.0]] * 2, dtype=torch.float32)
    wb = torch.full((2, m), -1, dtype=torch.int32)
    wa = torch.zeros((2, nc), dtype=torch.int32)
    out = fn(c, lo, hi, par, wb, wa)
    ref = bb_torch.fragment_batch_ref(
        fn.W, p.is_int, c, lo, hi, par, wb, wa, F=4, D=fn.D, node_iters=200,
        max_ticks=fn.max_ticks,
    )
    for f in ref._fields:
        assert torch.equal(out[f], getattr(ref, f)), f
    assert int(out["nlog"].sum()) >= 2
    assert fn.launches == 0 and not fn.cluster_sizes and not fn.launch_lanes
    with pytest.raises(ValueError):
        fn.run(c, lo, hi, par, wb, wa, bb_launch_plan(m, n, fn.D, 2, H100_SMEM, H100_SMS, H100_HELD))

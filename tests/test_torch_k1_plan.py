"""K1's launch plan and its cluster-wide arg-max rules, on the CPU.

``dense_launch_plan`` (solver/cuda_lp.py) picks, per launch, how K1 runs a
lane: a warp ("packed"), a block ("block") or a cluster of C blocks
("cluster"), each holding the lane's tableau (or its column slice) in
shared memory; the kernel (csrc/dense_simplex.cu) only checks the plan.
On a cluster the pricing winner and the warm rebuild's pivot are found in
two levels, each block's best entry of its columns, then the best of the
blocks' winners, each comparison by ``beats`` (larger score, then lower
index); models of those reductions are held here against the plain
version's arg-max.  The kernel itself runs on the card:
tests/test_torch_cuda.py.
"""

import json
import os

import numpy as np
import pytest
import torch

from moip_aira_tpu_torch.api import backend_stats
from moip_aira_tpu_torch.io import read_problem
from moip_aira_tpu_torch.solver import simplex_torch as st
from moip_aira_tpu_torch.solver.cuda_lp import (
    DENSE_MAX_THREADS,
    DENSE_MIN_SLICE,
    DENSE_PACK_LANES,
    STATIC_SMEM_RESERVE,
    DensePlan,
    dense_cluster_sizes,
    dense_launch_plan,
    dense_plan_for,
    dense_smem_bytes,
    make_cuda_lp_batch,
)

EX = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
H100_SMEM = 232_448  # shared bytes an H100 block may opt into
H100_SMS = 132
CAP = H100_SMEM - STATIC_SMEM_RESERVE
#: a fake occupancy table: 30 clusters of four and 15 of eight, as the H100
#: holds them under K2's plans (PERF.md §6), and two blocks an SM
FAKE_HELD = {1: 264, 2: 66, 4: 30, 8: 15}


def shape(name):
    p = read_problem(os.path.join(EX, name))
    return p.m_total, p.n


@pytest.mark.parametrize(
    "name", ["G3KP10.lp", "KP2D50.lp", "G2AP05.lp", "G3AP05.lp", "moip_2_30_knapsack.mop"]
)
@pytest.mark.parametrize("lanes", [1, 27, 212, 256])
def test_tiny_lps_run_a_warp_a_lane(name, lanes):
    """Every LP of at most 32 rows and 128 columns runs packed, four lanes
    (warps) a block, whatever the lane count."""
    m, n = shape(name)
    plan = dense_launch_plan(m, n, lanes, H100_SMEM, H100_SMS, FAKE_HELD)
    assert (plan.shape, plan.C, plan.P) == ("packed", 1, DENSE_PACK_LANES)
    assert plan.threads == 32 * plan.P and plan.layout == f"{plan.P} x T"
    assert plan.smem_bytes <= CAP
    assert plan.blocks(lanes) == -(-lanes // plan.P)


@pytest.mark.parametrize(
    "lanes,want",
    # 1 lane: the largest cluster whose slice keeps DENSE_MIN_SLICE columns
    # (8 blocks would leave 56); 31-66 lanes: more than the 30 clusters of
    # four the fake table holds, so two; past the 66 clusters of two it
    # holds, one block a lane with the whole tableau
    [(1, ("cluster", 4)), (30, ("cluster", 4)), (31, ("cluster", 2)),
     (32, ("cluster", 2)), (64, ("cluster", 2)), (66, ("cluster", 2)),
     (67, ("block", 1)), (256, ("block", 1))],
)
def test_2ap20_plan_by_lanes(lanes, want):
    m, n = shape("2AP20.lp")
    plan = dense_launch_plan(m, n, lanes, H100_SMEM, H100_SMS, FAKE_HELD)
    assert (plan.shape, plan.C) == want
    assert plan.smem_bytes <= CAP
    assert 64 <= plan.threads <= DENSE_MAX_THREADS and plan.threads % 32 == 0
    # every column of the slice has a thread, as few columns a thread as
    # DENSE_MAX_THREADS allows, spread evenly (442 columns: 224 threads of 2)
    per = -(-plan.width // DENSE_MAX_THREADS)
    assert plan.threads * per >= plan.width > (plan.threads - 32) * per
    assert plan.layout == ("T" if plan.C == 1 else f"T/{plan.C}")


@pytest.mark.parametrize("name", ["2AP20.lp", "2AP40.lp"])
@pytest.mark.parametrize("lanes", [1, 32, 64, 256])
def test_no_plan_queues_clusters(name, lanes):
    """With the fake occupancy table no plan launches more lanes at C > 1
    than the card holds clusters of C, except 2AP40's 32 and more lanes,
    which no cluster size holds at once: they take the C of the fewest
    rounds of clusters (four: 30 held against 15 of eight)."""
    m, n = shape(name)
    plan = dense_launch_plan(m, n, lanes, H100_SMEM, H100_SMS, FAKE_HELD)
    nc = n + m
    fits = [C for C in dense_cluster_sizes(nc) if dense_smem_bytes("cluster", m, nc, C) <= CAP]
    if name == "2AP40.lp" and lanes > max(FAKE_HELD[C] for C in fits):
        assert plan.C == 4
    else:
        assert plan.C == 1 or lanes <= FAKE_HELD[plan.C], (lanes, plan)


def test_2ap40_takes_a_cluster_whose_slice_fits():
    """2AP40's tableau (82 x 1682, 552 KB) fits no block; a cluster of four
    or eight holds it in shared memory, a quarter slice at 138 KB a block."""
    m, n = shape("2AP40.lp")
    nc = n + m
    with pytest.raises(ValueError):
        dense_plan_for(m, n, "block", 1, H100_SMEM)
    with pytest.raises(ValueError):
        dense_plan_for(m, n, "cluster", 2, H100_SMEM)
    for C in (4, 8):
        plan = dense_plan_for(m, n, "cluster", C, H100_SMEM)
        assert plan.smem_bytes <= CAP and plan.width == -(-nc // C)
    assert 4 * m * dense_plan_for(m, n, "cluster", 4, H100_SMEM).width == 4 * 82 * 421  # 138 KB
    for lanes in (1, 8, 15, 16, 30, 31, 256):
        plan = dense_launch_plan(m, n, lanes, H100_SMEM, H100_SMS, FAKE_HELD)
        assert plan.shape == "cluster" and plan.C in (4, 8)
        assert plan.smem_bytes <= CAP
    assert dense_launch_plan(m, n, 15, H100_SMEM, H100_SMS, FAKE_HELD).C == 8
    assert dense_launch_plan(m, n, 16, H100_SMEM, H100_SMS, FAKE_HELD).C == 4
    # past what any size holds: the fewest rounds, then the larger C
    even = {4: 30, 8: 30}
    assert dense_launch_plan(m, n, 256, H100_SMEM, H100_SMS, even).C == 8
    assert dense_launch_plan(m, n, 256, H100_SMEM, H100_SMS, {4: 30, 8: 14}).C == 4


def test_a_shape_nothing_fits_raises():
    m, n = shape("2AP100.lp")  # 202 x 10202: an eighth is 1 MB
    with pytest.raises(ValueError):
        dense_launch_plan(m, n, 1, H100_SMEM, H100_SMS, FAKE_HELD)
    m, n = shape("2AP20.lp")
    for bad in (("packed", 1), ("block", 2), ("cluster", 1), ("cluster", 16), ("warp", 1)):
        with pytest.raises(ValueError):
            dense_plan_for(m, n, *bad, H100_SMEM)
    with pytest.raises(ValueError):  # a card with too little shared memory
        dense_launch_plan(m, n, 256, 16 * 1024, H100_SMS, FAKE_HELD)


def test_smem_bytes_by_part():
    """The wrapper's byte count, part by part (the kernel's own count is
    checked against it at every launch on the card)."""
    m, nc = 42, 442
    vec = 4 * (4 * nc + 9 * m) + 4 * 2 * m + 2 * nc
    assert dense_smem_bytes("block", m, nc) == (4 * m * nc + vec + 4 * 2 * m + 15) & ~15
    assert dense_smem_bytes("cluster", m, nc, 4) == (4 * m * 111 + vec + 4 * 8 * m + 15) & ~15
    lane = 4 * (4 * 14 + 4 * 14 + 3 * 4) + 2 * 14
    assert dense_smem_bytes("packed", 4, 14, 1, 4) == 4 * ((lane + 15) & ~15)
    assert DensePlan(m, nc, "cluster", 4, 128).smem_bytes == dense_smem_bytes("cluster", m, nc, 4)
    for shape_, C in (("block", 1), ("cluster", 2), ("cluster", 4)):
        assert dense_smem_bytes(shape_, m, nc, C) % 16 == 0


@pytest.mark.parametrize("name", ["2AP20.lp", "2AP40.lp"])
def test_cluster_slices_cover_every_column_once(name):
    m, n = shape(name)
    nc = n + m
    for C in dense_cluster_sizes(nc):
        plan = DensePlan(m, nc, "cluster", C, 128)
        cols = np.concatenate([np.arange(a, b) for a, b in plan.slices])
        assert np.array_equal(cols, np.arange(nc))
        assert all(b - a >= DENSE_MIN_SLICE for a, b in plan.slices)


# ---- the two-level arg-max --------------------------------------------------


def beats(a, ia, b, ib):
    return a > b or (a == b and ia < ib)


def split_argmax(score, C):
    """The kernel's cluster arg-max over a row-major (m, nc) score table:
    each block's best entry of its columns, keyed by the entry's row-major
    index i * nc + j, then the best of the C winners."""
    m, nc = score.shape
    w = -(-nc // C)
    wins = []
    for r in range(C):
        best = (float("-inf"), 2**31 - 1)
        for i in range(m):
            for j in range(r * w, min(nc, r * w + w)):
                if beats(score[i, j], i * nc + j, *best):
                    best = (float(score[i, j]), i * nc + j)
        wins.append(best)
    best = (float("-inf"), 2**31 - 1)
    for v in wins:
        if beats(*v, *best):
            best = v
    return best


@pytest.mark.parametrize("seed", range(6))
def test_rebuild_pivot_across_slices_is_the_plain_versions(seed):
    """The warm rebuild's pivot on a cluster: with ties everywhere, the
    first of equal maxima in row-major order, which is what the plain
    version's row arg-max, then column arg-max, picks."""
    rng = np.random.default_rng(seed)
    m, nc = 7, 45
    score = rng.integers(0, 4, size=(m, nc)).astype(np.float32)
    score[rng.random((m, nc)) < 0.3] = 0.0
    t = torch.as_tensor(score)
    r = int(t.amax(1).argmax())
    cb = int(t[r].argmax())
    for C in (1, 2, 4, 8):
        v, e = split_argmax(score, C)
        assert (e // nc, e % nc) == (r, cb) and v == score[r, cb]


@pytest.mark.parametrize("seed", range(4))
def test_pricing_across_slices_is_the_plain_versions(seed):
    """The entering column on a cluster: each block's winner of its slice,
    then the best of the winners, equals the plain version's ``_entering``
    over the whole row (Dantzig, then Bland)."""
    rng = np.random.default_rng(seed)
    nc = 442
    d = torch.as_tensor(rng.choice([-2.0, -1.0, 0.0, 1.0, 2.0], size=(1, nc)), dtype=torch.float32)
    in_basis = torch.as_tensor(rng.random((1, nc)) < 0.1)
    at_upper = torch.as_tensor(rng.random((1, nc)) < 0.2) & ~in_basis
    free = torch.zeros(1, nc, dtype=torch.bool)
    neg_col = -torch.arange(nc, dtype=torch.float32)
    for bland in (False, True):
        q, _, _ = st._entering(d, in_basis, at_upper, free, torch.tensor([bland]), 3e-5, neg_col)
        can_up = ~in_basis & ~at_upper & (d < -3e-5)
        can_dn = ~in_basis & at_upper & (d > 3e-5)
        el = (can_up | can_dn)[0].numpy()
        dd = d[0].numpy()
        score = np.where(el, -np.arange(nc, dtype=np.float32) if bland else np.abs(dd),
                         -1e30 if bland else -1.0).astype(np.float32)
        for C in (1, 2, 4, 8):
            v, j = split_argmax(score[None, :], C)
            assert j == int(q[0]), (bland, C)


# ---- the wrapper on the CPU ----------------------------------------------


def test_k1_wrapper_on_the_cpu_runs_the_plain_version_only():
    """On CPU tensors K1's wrapper runs dense_lp_batch_ref and counts no
    launch; a launch plan needs CUDA tensors and raises on the CPU."""
    from moip_aira_tpu_torch.convert import lp_tensors

    p = read_problem(os.path.join(EX, "G3KP10.lp"))
    t = lp_tensors(p, torch.device("cpu"))
    k1 = make_cuda_lp_batch(t.W_dev, torch.device("cpu"))
    m, n = p.m_total, p.n
    B = 4
    c = torch.zeros(B, n + m)
    c[:, :n] = -torch.as_tensor(p.C[0], dtype=torch.float32)
    lo = torch.as_tensor(np.tile(np.concatenate([p.lb, p.row_lb, np.full(p.objcnt, -np.inf)]), (B, 1)),
                         dtype=torch.float32)
    hi = torch.as_tensor(np.tile(np.concatenate([p.ub, p.row_ub, np.full(p.objcnt, np.inf)]), (B, 1)),
                         dtype=torch.float32)
    lo[:, n:] *= torch.as_tensor(t.row_scale, dtype=torch.float32)
    hi[:, n:] *= torch.as_tensor(t.row_scale, dtype=torch.float32)
    wb = torch.full((B, m), -1, dtype=torch.int32)
    wa = torch.zeros((B, n + m), dtype=torch.int32)
    out = k1(c, lo, hi, wb, wa)
    ref = st.dense_lp_batch_ref(k1.W, c, lo, hi, wb, wa)
    for f in out._fields:
        assert torch.equal(getattr(out, f), getattr(ref, f)), f
    plan = dense_launch_plan(m, n, B, H100_SMEM, H100_SMS, FAKE_HELD)
    with pytest.raises(ValueError):
        k1.run(c, lo, hi, wb, wa, plan)
    assert k1.launches == 0 and not k1.plan_shapes and not k1.launch_lanes


def test_backend_stats_report_k1_launches_by_plan():
    """backend_stats carries K1's launches by plan shape and by (shape, C,
    lanes) as JSON rows; K2's wrapper reports none of them."""
    from types import SimpleNamespace

    from moip_aira_tpu_torch.solver.cuda_lp import make_cuda_rev_batch

    W = torch.zeros(2, 5)
    k1 = make_cuda_lp_batch(W, torch.device("cpu"))
    k1.launches = 3
    k1.plan_shapes.update({"packed": 2, "cluster": 1})
    k1.launch_lanes.update({("packed", 1, 27): 2, ("cluster", 4, 1): 1})
    stats = backend_stats(SimpleNamespace(name="wave", device_waves=3, lp_count=55,
                                          verify_fallbacks=0, lp_kernel=k1))
    assert stats["plan_shapes"] == {"packed": 2, "cluster": 1}
    assert stats["launch_lanes"] == [["cluster", 4, 1, 1], ["packed", 1, 27, 2]]
    assert json.loads(json.dumps(stats)) == stats
    k2 = make_cuda_rev_batch(W, torch.device("cpu"))
    stats = backend_stats(SimpleNamespace(name="wave", lp_kernel=k2))
    assert stats["kernel"] == "revised_simplex" and "plan_shapes" not in stats

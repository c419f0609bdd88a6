"""K1, K2, K3 and K4, the CUDA kernels, against their plain PyTorch
versions on the card; the lex backend's kernel (plain PyTorch, CUDA graphs
on the card) against the same call on the CPU, and the mesh of the visible
cards.

Every test here needs an NVIDIA GPU and skips without one.  The file
imports no jax, so on a machine with a card and without jax it runs alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import os

import numpy as np
import pytest
import torch

from moip_aira_tpu_torch.convert import lp_tensors
from moip_aira_tpu_torch.io import read_problem
from moip_aira_tpu_torch.solver import simplex_torch as st
from moip_aira_tpu_torch.sense import Sense
from moip_aira_tpu_torch.solver.cuda_lp import make_cuda_lp_batch, make_cuda_rev_batch

EX = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
B = 16


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def lanes(name, dev, seed, count=B):
    """``count`` lanes of ``name`` on ``dev``: one stage objective per lane,
    free objective rows, a few integer fixes on the lanes after the first,
    and logical bounds row-scaled as the wave scales them."""
    rng = np.random.default_rng(seed)
    p = read_problem(os.path.join(EX, name))
    t = lp_tensors(p, dev)
    n, m, k = p.n, p.m_total, p.objcnt
    c = np.zeros((count, n + m))
    for b in range(count):
        c[b, :n] = (1.0 if p.objsen is Sense.MIN else -1.0) * p.C[b % k]
    free = np.full(k, np.inf)
    lo = np.tile(np.concatenate([p.lb, p.row_lb, -free]), (count, 1))
    hi = np.tile(np.concatenate([p.ub, p.row_ub, free]), (count, 1))
    for b in range(1, count):
        for v in rng.choice(n, size=int(rng.integers(1, 4)), replace=False):
            if rng.random() < 0.5 or not np.isfinite(hi[b, v]):
                hi[b, v] = lo[b, v]
            else:
                lo[b, v] = hi[b, v]
    lo[:, n:] *= t.row_scale
    hi[:, n:] *= t.row_scale
    args = [torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (c, lo, hi)]
    return t, args


@pytest.mark.cuda
@pytest.mark.parametrize(
    "name",
    # each with the plan K1's wrapper picks for 16 lanes: the tiny LPs a
    # warp a lane, 2AP20 a cluster of blocks, 2AP40 (82 x 1682, a 552 KB
    # tableau) a cluster whose slices sit in shared memory
    [
        "G2AP05.lp", "G3KP10.lp", "KP2D50.lp", "moip_2_30_knapsack.mop",
        "2AP20.lp", "2AP40.lp",
    ],
)
def test_kernel_matches_plain_bit_for_bit(cuda_device, name):
    """K1 and its plain version sum in the same order, so on the same CUDA
    inputs they agree exactly, warm lanes and a singular warm basis (which
    falls back to the cold start) included."""
    dev = cuda_device
    t, args = lanes(name, dev, seed=5)
    k1 = make_cuda_lp_batch(t.W_dev, dev)
    m, nc = t.W_dev.shape
    wb = torch.full((B, m), -1, dtype=torch.int32, device=dev)
    wa = torch.zeros((B, nc), dtype=torch.int32, device=dev)
    first = k1(*args, wb, wa)
    wb_w = first.basis.clone()
    wa_w = first.at_upper.clone()
    wb_w[1::2] = -1
    wa_w[1::2] = 0
    wb_w[2] = int(torch.nonzero(t.W_dev[0] == 0)[0])  # one column m times
    for wbx, wax in ((wb, wa), (wb_w, wa_w)):
        out = k1(*args, wbx, wax)
        ref = st.dense_lp_batch_ref(k1.W, *args, wbx, wax)
        torch.cuda.synchronize()
        for f in out._fields:
            assert torch.equal(getattr(out, f), getattr(ref, f)), f
    assert (first.status == st.OPTIMAL).any()
    assert k1.launches == 3


@pytest.mark.cuda
def test_kernel_refuses_tensors_on_another_device(cuda_device):
    t, args = lanes("G2AP05.lp", cuda_device, seed=0)
    k1 = make_cuda_lp_batch(t.W_dev, cuda_device)
    m, nc = t.W_dev.shape
    wb = torch.full((B, m), -1, dtype=torch.int32)
    wa = torch.zeros((B, nc), dtype=torch.int32)
    with pytest.raises(ValueError):
        k1(*(a.cpu() for a in args), wb, wa)
    assert k1.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize(
    "name,shape,C,P",
    # every shape each LP allows: a warp a lane (P lanes a block; 13 lanes
    # leave the last block part empty) for the LPs of at most 32 rows and
    # 128 columns, a block and clusters of two, four and eight at 2AP20,
    # clusters of four and eight at 2AP40 (its tableau fits no block)
    [
        ("G3KP10.lp", "packed", 1, 4), ("KP2D50.lp", "packed", 1, 4),
        ("G2AP05.lp", "packed", 1, 1), ("G2AP05.lp", "packed", 1, 4),
        ("G2AP05.lp", "packed", 1, 8), ("moip_2_30_knapsack.mop", "packed", 1, 4),
        ("2AP20.lp", "block", 1, 1), ("2AP20.lp", "cluster", 2, 1),
        ("2AP20.lp", "cluster", 4, 1), ("2AP20.lp", "cluster", 8, 1),
        ("2AP40.lp", "cluster", 4, 1), ("2AP40.lp", "cluster", 8, 1),
    ],
)
def test_dense_plans_match_plain_bit_for_bit(cuda_device, name, shape, C, P):
    """K1 through ``run(..., plan)`` in every shape: every raw output of
    every lane equal to the plain version's, cold and with half the lanes
    warm from the first launch's bases, one of them singular (it falls back
    to the cold start)."""
    from moip_aira_tpu_torch.solver.cuda_lp import dense_plan_for

    dev = cuda_device
    count = 13
    t, args = lanes(name, dev, seed=5, count=count)
    k1 = make_cuda_lp_batch(t.W_dev, dev)
    m, nc = t.W_dev.shape
    smem, _ = k1.device_limits
    plan = dense_plan_for(m, nc - m, shape, C, smem, P)
    assert k1.max_clusters(plan) >= 1
    wb = torch.full((count, m), -1, dtype=torch.int32, device=dev)
    wa = torch.zeros((count, nc), dtype=torch.int32, device=dev)
    first = k1.run(*args, wb, wa, plan)
    wb_w = first.basis.clone()
    wa_w = first.at_upper.clone()
    wb_w[1::2] = -1
    wa_w[1::2] = 0
    wb_w[2] = int(torch.nonzero(t.W_dev[0] == 0)[0])  # one column m times
    for wbx, wax in ((wb, wa), (wb_w.contiguous(), wa_w.contiguous())):
        out = k1.run(*args, wbx, wax, plan)
        ref = st.dense_lp_batch_ref(k1.W, *args, wbx, wax)
        torch.cuda.synchronize()
        for f in out._fields:
            assert torch.equal(getattr(out, f), getattr(ref, f)), (plan, f)
    assert (first.status == st.OPTIMAL).any()
    assert k1.launches == 3 and k1.plan_shapes == {shape: 3}
    assert k1.launch_lanes == {(shape, C, count): 3}


@pytest.mark.cuda
def test_dense_plan_on_this_card(cuda_device):
    """The plans K1's wrapper picks here: a warp a lane for the tiny LPs, a
    cluster for a lone 2AP20 lane and a block a lane for 256, a cluster
    with the tableau's slices in shared memory at 2AP40; no launch of C > 1
    holds more lanes than the card holds clusters of C."""
    dev = cuda_device
    for name in ("G3KP10.lp", "KP2D50.lp", "G2AP05.lp"):
        t, _ = lanes(name, dev, seed=0, count=2)
        assert make_cuda_lp_batch(t.W_dev, dev).plan(27).shape == "packed"
    for name, want in (("2AP20.lp", {1: "cluster", 256: "block"}), ("2AP40.lp", {1: "cluster", 256: "cluster"})):
        t, _ = lanes(name, dev, seed=0, count=2)
        k1 = make_cuda_lp_batch(t.W_dev, dev)
        for lanes_n, shape in want.items():
            plan = k1.plan(lanes_n)
            assert plan.shape == shape, (name, lanes_n, plan)
            assert plan.smem_bytes <= k1.device_limits[0]
        assert k1.plan(1).C > 1
        for lanes_n in range(1, 140):
            plan = k1.plan(lanes_n)
            assert plan.C == 1 or lanes_n <= k1.held[plan.C] or name == "2AP40.lp", (name, lanes_n, plan)


@pytest.mark.cuda
def test_dense_kernel_refuses_a_plan_that_does_not_fit(cuda_device):
    """A K1 plan whose shape, shared memory, block or cluster the kernel
    cannot take is refused before the launch and raises; nothing is
    counted."""
    from dataclasses import replace

    from moip_aira_tpu_torch.solver.cuda_lp import DensePlan

    dev = cuda_device
    t, args = lanes("2AP40.lp", dev, seed=0, count=4)
    k1 = make_cuda_lp_batch(t.W_dev, dev)
    m, nc = t.W_dev.shape
    wb = torch.full((4, m), -1, dtype=torch.int32, device=dev)
    wa = torch.zeros((4, nc), dtype=torch.int32, device=dev)
    plan = k1.plan(4)
    for bad in (
        replace(plan, C=2),  # half the tableau a block: 276 KB
        replace(plan, threads=48),
        replace(plan, C=16),
        DensePlan(m, nc, "block", 1, 256),  # all of it: 552 KB
        DensePlan(m, nc, "packed", 1, 128, 4),  # 82 rows on a warp
    ):
        with pytest.raises(RuntimeError):
            k1.run(*args, wb, wa, bad)
    assert k1.launches == 0 and not k1.plan_shapes


@pytest.mark.cuda
@pytest.mark.parametrize(
    "name",
    # 2AP40 (82 x 1682) keeps B^-1 and the warm block in shared memory;
    # 2AP100 (202 x 10202) only B^-1, its warm block in the global scratch
    ["G2AP05.lp", "2AP40.lp", "2AP100.lp"],
)
def test_revised_kernel_matches_plain_bit_for_bit(cuda_device, name):
    """K2 and its plain version sum in the same order, so on the same CUDA
    inputs they agree exactly, warm lanes and a singular warm basis (which
    falls back to the cold start) included."""
    dev = cuda_device
    t, args = lanes(name, dev, seed=5)
    k2 = make_cuda_rev_batch(t.W_dev, dev)
    m, nc = t.W_dev.shape
    wb = torch.full((B, m), -1, dtype=torch.int32, device=dev)
    wa = torch.zeros((B, nc), dtype=torch.int32, device=dev)
    first = k2(*args, wb, wa)
    wb_w = first.basis.clone()
    wa_w = first.at_upper.clone()
    wb_w[1::2] = -1
    wa_w[1::2] = 0
    wb_w[2] = int(torch.nonzero(t.W_dev[0] == 0)[0])  # one column m times
    for wbx, wax in ((wb, wa), (wb_w, wa_w)):
        out = k2(*args, wbx, wax)
        ref = st.revised_lp_batch_ref(k2.W, *args, wbx, wax)
        torch.cuda.synchronize()
        for f in out._fields:
            assert torch.equal(getattr(out, f), getattr(ref, f)), f
    assert (first.status == st.OPTIMAL).any()
    assert k2.launches == 3


@pytest.mark.cuda
def test_revised_kernel_refuses_tensors_on_another_device(cuda_device):
    t, args = lanes("G2AP05.lp", cuda_device, seed=0)
    k2 = make_cuda_rev_batch(t.W_dev, cuda_device)
    m, nc = t.W_dev.shape
    wb = torch.full((B, m), -1, dtype=torch.int32)
    wa = torch.zeros((B, nc), dtype=torch.int32)
    with pytest.raises(ValueError):
        k2(*(a.cpu() for a in args), wb, wa)
    assert k2.launches == 0


#: the plain version's outcome on REV_LANES lanes of each shape, cold and
#: half warm, filled by the first test that needs it: a lane's outcome does
#: not depend on its batch, so each launch below is held against the rows
#: of its lanes
_REV_CASES = {}
REV_LANES = 256


def rev_case(name, dev):
    if name not in _REV_CASES:
        t, args = lanes(name, dev, seed=11, count=REV_LANES)
        m, nc = t.W_dev.shape
        W = t.W_dev.to(dev, torch.float32).contiguous()
        wb = torch.full((REV_LANES, m), -1, dtype=torch.int32, device=dev)
        wa = torch.zeros((REV_LANES, nc), dtype=torch.int32, device=dev)
        cold = st.revised_lp_batch_ref(W, *args, wb, wa)
        even = (torch.arange(REV_LANES, device=dev) % 2 == 0)[:, None]
        wb_w = torch.where(even, cold.basis, -1).contiguous()
        wa_w = torch.where(even, cold.at_upper, 0).contiguous()
        warm = st.revised_lp_batch_ref(W, *args, wb_w, wa_w)
        _REV_CASES[name] = (t, args, {"cold": (wb, wa, cold), "warm": (wb_w, wa_w, warm)})
    return _REV_CASES[name]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["G2AP05.lp", "2AP20.lp", "2AP40.lp", "2AP100.lp"])
# every C the launch plan returns: G2AP05 and 2AP20 1; 2AP40 4 up to 33
# lanes, 2 at 64 and 1 at 256; 2AP100 8 up to 16 lanes, 2 at 64, 1 at 256
@pytest.mark.parametrize("lanes_n", [1, 8, 64, 256])
def test_revised_cluster_plans_match_plain_bit_for_bit(cuda_device, name, lanes_n):
    """K2 on the first ``lanes_n`` lanes, with the cluster the plan picks
    for them, equals the plain version's rows of those lanes bit for bit,
    cold and with every other lane warm."""
    from moip_aira_tpu_torch.solver.cuda_lp import REV_MAX_CLUSTER

    dev = cuda_device
    t, args, starts = rev_case(name, dev)
    k2 = make_cuda_rev_batch(t.W_dev, dev)
    plan = k2.plan(lanes_n)
    assert 1 <= plan.C <= REV_MAX_CLUSTER and k2.max_clusters(plan) >= 1
    want = {
        "G2AP05.lp": {1: 1, 8: 1, 64: 1, 256: 1},
        "2AP20.lp": {1: 1, 8: 1, 64: 1, 256: 1},
        "2AP40.lp": {1: 4, 8: 4, 64: 2, 256: 1},
        "2AP100.lp": {1: 8, 8: 8, 64: 2, 256: 1},
    }[name][lanes_n]
    assert plan.C == want
    for label, (wb, wa, ref) in starts.items():
        out = k2(*(a[:lanes_n] for a in args), wb[:lanes_n], wa[:lanes_n])
        torch.cuda.synchronize()
        for f in out._fields:
            assert torch.equal(getattr(out, f), getattr(ref, f)[:lanes_n]), (label, f)
    assert k2.cluster_sizes == {plan.C: 2}


@pytest.mark.cuda
def test_revised_kernel_refuses_a_plan_that_does_not_fit(cuda_device):
    """A plan whose shared memory or block shape the kernel cannot take is
    refused before the launch and raises; nothing is counted."""
    from dataclasses import replace

    t, args = lanes("2AP100.lp", cuda_device, seed=0)
    k2 = make_cuda_rev_batch(t.W_dev, cuda_device)
    m, nc = t.W_dev.shape
    wb = torch.full((B, m), -1, dtype=torch.int32, device=cuda_device)
    wa = torch.zeros((B, nc), dtype=torch.int32, device=cuda_device)
    plan = k2.plan(B)
    for bad in (
        replace(plan, w_smem=True, p1_smem=True),  # 1 MB of W slice a block
        replace(plan, threads=48),
        replace(plan, C=16),
    ):
        with pytest.raises(RuntimeError):
            k2.run(*args, wb, wa, bad)
    assert k2.launches == 0 and not k2.cluster_sizes


def fragment_lanes(name, dev, lanes_n, seed):
    """K3's lanes at ``name``'s shape: stage roots (one objective each) whose
    objective-bound box is cut inside the golden front's range on most
    lanes, so that their LPs are fractional and the lanes branch; logical
    bounds row-scaled; no incumbent on half the lanes and a finite one on
    the other half."""
    rng = np.random.default_rng(seed)
    p = read_problem(os.path.join(EX, name))
    t = lp_tensors(p, dev)
    n, m, k = p.n, p.m_total, p.objcnt
    front = np.array([
        [int(v) for v in line.split()]
        for line in open(os.path.join(EX, name.replace(".lp", ".out")))
        if line.split() and all(v.lstrip("-").isdigit() for v in line.split())
    ])
    is_min = p.objsen is Sense.MIN
    c = np.zeros((lanes_n, n + m))
    lo = np.zeros((lanes_n, n + m))
    hi = np.zeros((lanes_n, n + m))
    for b in range(lanes_n):
        c[b, :n] = (1.0 if is_min else -1.0) * p.C[b % k]
        box = np.full(k, np.inf if is_min else -np.inf)
        for jj in range(k):
            if b > 0 and rng.random() < 0.6:
                box[jj] = float(rng.integers(front[:, jj].min(), front[:, jj].max() + 1))
        olo, ohi = (np.full(k, -np.inf), box) if is_min else (box, np.full(k, np.inf))
        lo[b] = np.concatenate([p.lb, p.row_lb, olo])
        hi[b] = np.concatenate([p.ub, p.row_ub, ohi])
    lo[:, n:] *= t.row_scale
    hi[:, n:] *= t.row_scale
    c, lo, hi = (torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous() for a in (c, lo, hi))
    par = torch.zeros((lanes_n, 4), dtype=torch.float32, device=dev)
    par[:, 0] = float("inf")
    par[1::2, 0] = 1e4
    par[:, 1] = 1.0
    par[:, 3] = 1.0
    return p, t, c, lo, hi, par


@pytest.mark.cuda
@pytest.mark.parametrize(
    "name,lanes_n,F,max_ticks",
    # the smoke's three shapes, each on the cluster its plan picks: G3KP10
    # (deep trees, budget stops), 2AP20 (all in shared memory, W too),
    # 2AP40 (82 x 1682, a W slice in shared memory on four blocks, a tick
    # stop)
    [("G3KP10.lp", 64, 32, 8192), ("2AP20.lp", 32, 32, 8192), ("2AP40.lp", 16, 8, 2000)],
)
def test_fragment_kernel_matches_plain_bit_for_bit(cuda_device, name, lanes_n, F, max_ticks):
    """K3 and its plain version walk the same trees: every raw output of
    every lane equal, cold and with half the lanes warm from the first
    launch's final bases (one of them singular)."""
    from moip_aira_tpu_torch.solver.bb_torch import fragment_batch_ref
    from moip_aira_tpu_torch.solver.cuda_bb import make_cuda_bb_batch

    dev = cuda_device
    p, t, c, lo, hi, par = fragment_lanes(name, dev, lanes_n, seed=7)
    par[:, 2] = F
    m, nc = t.W_dev.shape
    node_iters = max(200, 6 * m)
    fn, meta = make_cuda_bb_batch(
        t.W_dev, p.is_int, dev, F=F, D=128, node_iters=node_iters, max_ticks=max_ticks
    )
    first = fn(c, lo, hi, par)
    wb = first["fin_basis"].clone()
    wa = torch.as_tensor(meta["unpack_atup1"](first["fin_atup"].cpu().numpy()), dtype=torch.int32, device=dev)
    wb[1::2] = -1
    wa[1::2] = 0
    wb[2] = int(torch.nonzero(t.W_dev[0] == 0)[0])
    for wbx, wax in ((None, None), (wb.contiguous(), wa.contiguous())):
        out = fn(c, lo, hi, par, wbx, wax)
        if wbx is None:
            wbx = torch.full((lanes_n, m), -1, dtype=torch.int32, device=dev)
            wax = torch.zeros((lanes_n, nc), dtype=torch.int32, device=dev)
        ref = fragment_batch_ref(
            fn.W, p.is_int, c, lo, hi, par, wbx, wax, F=F, D=128,
            node_iters=node_iters, max_ticks=max_ticks,
        )
        torch.cuda.synchronize()
        for f in ref._fields:
            assert torch.equal(out[f], getattr(ref, f)), f
    assert int(first["nlog"].sum()) > lanes_n and fn.launches == 3


@pytest.mark.cuda
@pytest.mark.parametrize(
    "name,lanes_n,F,max_ticks,sizes",
    # every C the shape allows: G3KP10 (14 columns) 1; 2AP20 1 (all of W
    # in shared memory) and 2; 2AP40 1, 2, 4 (the W slice in shared memory)
    # and 8
    [
        ("G3KP10.lp", 32, 32, 8192, (1,)),
        ("2AP20.lp", 16, 32, 8192, (1, 2)),
        ("2AP40.lp", 8, 8, 2000, (1, 2, 4, 8)),
    ],
)
def test_fragment_cluster_plans_match_plain_bit_for_bit(
    cuda_device, name, lanes_n, F, max_ticks, sizes
):
    """K3 through ``run(..., plan)`` at every cluster size the shape allows,
    cold and with half the lanes warm from the first launch's final bases:
    every raw output of every lane equal to the plain version's."""
    from moip_aira_tpu_torch.solver.bb_torch import fragment_batch_ref
    from moip_aira_tpu_torch.solver.cuda_bb import bb_plan_for, make_cuda_bb_batch
    from moip_aira_tpu_torch.solver.cuda_lp import cluster_sizes_for

    dev = cuda_device
    p, t, c, lo, hi, par = fragment_lanes(name, dev, lanes_n, seed=5)
    par[:, 2] = F
    m, nc = t.W_dev.shape
    n = nc - m
    assert tuple(cluster_sizes_for(nc)) == sizes
    node_iters = max(200, 6 * m)
    fn, meta = make_cuda_bb_batch(
        t.W_dev, p.is_int, dev, F=F, D=128, node_iters=node_iters, max_ticks=max_ticks
    )
    smem, _ = fn.device_limits
    first = fn(c, lo, hi, par)
    wb = first["fin_basis"].clone()
    wa = torch.as_tensor(meta["unpack_atup1"](first["fin_atup"].cpu().numpy()), dtype=torch.int32, device=dev)
    wb[1::2] = -1
    wa[1::2] = 0
    cold = (
        torch.full((lanes_n, m), -1, dtype=torch.int32, device=dev),
        torch.zeros((lanes_n, nc), dtype=torch.int32, device=dev),
    )
    for wbx, wax in (cold, (wb.contiguous(), wa.contiguous())):
        ref = fragment_batch_ref(
            fn.W, p.is_int, c, lo, hi, par, wbx, wax, F=F, D=128,
            node_iters=node_iters, max_ticks=max_ticks,
        )
        for C in sizes:
            plan = bb_plan_for(m, n, 128, C, smem)
            assert fn.max_clusters(plan) >= 1
            out = fn.run(c, lo, hi, par, wbx, wax, plan)
            torch.cuda.synchronize()
            for f in ref._fields:
                assert torch.equal(out[f], getattr(ref, f)), (C, f)
    assert int(first["nlog"].sum()) > lanes_n
    want = {C: 2 for C in sizes}
    want[fn.plan(lanes_n).C] += 1
    assert fn.cluster_sizes == want


@pytest.mark.cuda
def test_fragment_plan_uses_clusters_and_shared_w(cuda_device):
    """The plan K3's wrapper picks on this card: all of W in shared memory
    at 2AP20 with one block a lane; at 2AP40 a W slice in shared memory on a
    cluster of four up to the clusters of four the card holds, never more
    lanes than clusters at C > 1."""
    from moip_aira_tpu_torch.solver.cuda_bb import make_cuda_bb_batch

    dev = cuda_device
    for name, want in (("2AP20.lp", {1: 1, 64: 1, 256: 1}), ("2AP40.lp", {1: 4, 8: 4})):
        p = read_problem(os.path.join(EX, name))
        t = lp_tensors(p, dev)
        fn, _ = make_cuda_bb_batch(t.W_dev, p.is_int, dev, F=8)
        for lanes_n, C in want.items():
            plan = fn.plan(lanes_n)
            assert plan.C == C and plan.w_smem and plan.bi_smem, (name, lanes_n, plan)
        for lanes_n in range(1, 200):
            plan = fn.plan(lanes_n)
            assert plan.C == 1 or lanes_n <= fn.held[plan.C], (name, lanes_n, plan)


@pytest.mark.cuda
def test_fragment_kernel_refuses_a_plan_that_does_not_fit(cuda_device):
    """A K3 plan whose shared memory, block or cluster the kernel cannot
    take is refused before the launch and raises; nothing is counted."""
    from dataclasses import replace

    from moip_aira_tpu_torch.solver.cuda_bb import make_cuda_bb_batch

    p, t, c, lo, hi, par = fragment_lanes("2AP40.lp", cuda_device, 4, seed=5)
    par[:, 2] = 8
    fn, _ = make_cuda_bb_batch(t.W_dev, p.is_int, cuda_device, F=8, max_ticks=200)
    m, nc = t.W_dev.shape
    wb = torch.full((4, m), -1, dtype=torch.int32, device=cuda_device)
    wa = torch.zeros((4, nc), dtype=torch.int32, device=cuda_device)
    plan = fn.plan(4)
    for bad in (
        replace(plan, C=1),  # all of W a block: 552 KB
        replace(plan, threads=48),
        replace(plan, C=16),
        replace(plan, bi_smem=False),  # the W slice without B^-1
    ):
        with pytest.raises(RuntimeError):
            fn.run(c, lo, hi, par, wb, wa, bad)
    assert fn.launches == 0 and not fn.cluster_sizes


def random_dp_items(seed, n=24, cap=300):
    """K4's items with several of weight 0 and of s-value 0, and one
    heavier than the capacity."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 40, n)
    w[:3] = 0
    w[-1] = cap + 1
    b = rng.integers(0, 100, n)
    a = rng.integers(0, 60, n)
    a[3:5] = 0
    return np.stack([w, b, a]).astype(np.int32), cap, int(a.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["G2KP50.lp", "random"])
def test_dp_kernel_matches_plain_bit_for_bit(cuda_device, name):
    """K4's full final table equals its plain version's on the card, one
    launch per item; its front equals the plain version's."""
    from moip_aira_tpu_torch.solver import kp_front as kf
    from moip_aira_tpu_torch.solver.cuda_dp import CudaKPDP

    dev = cuda_device
    if name == "random":
        arr, cap, S = random_dp_items(3)
        items = torch.as_tensor(arr, device=dev)
    else:
        kp = kf.detect_kp2(read_problem(os.path.join(EX, name)))
        items, cap, S = kf.dp_items(kp, dev), kp.cap, kf.value_sum(kp)
    dp = CudaKPDP()
    got = dp(items, cap, S)
    want = kf.dp_table_ref(items, cap, S)
    torch.cuda.synchronize()
    assert got.device == want.device and got.dtype == torch.int32
    assert torch.equal(got, want)
    assert dp.launches == items.shape[1]
    if name != "random":
        assert np.array_equal(kf.front_cuda(kp, dev), kf.front_torch(kp, dev))


@pytest.mark.cuda
def test_dp_kernel_refuses_bad_items(cuda_device):
    from moip_aira_tpu_torch.solver.cuda_dp import CudaKPDP

    arr, cap, S = random_dp_items(0)
    items = torch.as_tensor(arr, device=cuda_device)
    dp = CudaKPDP()
    with pytest.raises(TypeError):
        dp(items.long(), cap, S)
    with pytest.raises(ValueError):
        dp(torch.cat([items, items]).t()[:3], cap, S)
    bad = items.clone()
    bad[0, 1] = -1
    with pytest.raises(ValueError):
        dp(bad, cap, S)
    assert dp.launches == 0


def lex_case(name, lanes, seed):
    """``lanes`` lex requests of ``name``: the initial rhs and golden points
    moved by -1..1, each under a random ordering."""
    rng = np.random.default_rng(seed)
    p = read_problem(os.path.join(EX, f"{name}.lp"))
    gold = []
    with open(os.path.join(EX, f"{name}.out")) as fh:
        for line in fh:
            parts = line.split()
            if parts and all(t.lstrip("-").isdigit() for t in parts):
                gold.append([float(t) for t in parts])
    gold = np.array(gold)
    k = p.objcnt
    rhs = np.array([
        p.initial_rhs() if b == 0 else gold[rng.integers(len(gold))] + rng.integers(-1, 2, size=k)
        for b in range(lanes)
    ])
    perm = np.array([rng.permutation(k) for _ in range(lanes)])
    return p, rhs, perm


@pytest.mark.cuda
@pytest.mark.parametrize("name,lanes", [("G2AP05", 32), ("G3AP05", 32), ("G3KP10", 5)])
def test_lex_kernel_on_the_card_equals_the_cpu(cuda_device, name, lanes):
    """The lex kernel (plain PyTorch in f64; on the card each LP step is one
    CUDA graph) gives the CPU's statuses, results and IPs, twice in a row
    (the second call replays the captured graphs), and its results stay on
    the card."""
    from moip_aira_tpu_torch.solver.lex_torch import make_lex_kernel

    p, rhs, perm = lex_case(name, lanes, seed=3)
    want = [t.numpy() for t in make_lex_kernel(p, device="cpu")(rhs, perm)]
    kern = make_lex_kernel(p, device=cuda_device)
    for _ in range(2):
        out = kern(rhs, perm)
        assert all(t.is_cuda for t in out)
        for a, b in zip(out, want):
            assert np.array_equal(a.cpu().numpy(), b)
    assert kern.lp.W.is_cuda and kern.lp_steps > 0


@pytest.mark.cuda
def test_make_mesh_gives_one_domain_a_card(cuda_device):
    from moip_aira_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(8)
    cards = torch.cuda.device_count()
    assert mesh.size == min(8, cards)
    assert mesh.domain_devices() == [torch.device("cuda", i) for i in range(mesh.size)]
    assert make_mesh(1).domain_devices() == [torch.device("cuda", 0)]

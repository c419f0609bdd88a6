"""K1, K2, K3, K4 and K5, the CUDA kernels, against their plain PyTorch
versions on the card; the lex backend's kernel (K6, its whole batch in one
launch) and the wave's XLA engine (K5) against the same calls on the CPU,
and the mesh of the visible cards.

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


def lanes(name, dev, seed, count=B, scaled=True):
    """``count`` lanes of ``name`` on ``dev``: one stage objective per lane,
    free objective rows, a few integer fixes on the lanes after the first,
    and logical bounds row-scaled as the wave scales them for the kernels
    (``scaled``; the XLA engine solves the unscaled system)."""
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
    if scaled:
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


#: generated 3-objective knapsacks (``utils.generate.kp_lp``, seed 1):
#: name (rows x items) -> (items, capacity rows); their LPs, of 18, 20 and
#: 26 columns, take K6's regs builds of 8, 16 and 16 rows
LEX_GENERATED = {"KP6x12": (12, 3), "KP12x8": (8, 9), "KP16x10": (10, 13)}


def lex_problem(name):
    """An example problem, or one of LEX_GENERATED, and its points: the
    golden front's, or for a generated one the CPU lex kernel's points at
    the initial rhs under every ordering."""
    import itertools
    import tempfile

    from moip_aira_tpu_torch.solver.lex_torch import make_lex_kernel
    from moip_aira_tpu_torch.utils.generate import kp_lp

    if name in LEX_GENERATED:
        items, rows = LEX_GENERATED[name]
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, f"{name}.lp")
            with open(path, "w") as fh:
                fh.write(kp_lp(items, 3, 1, constraints=rows))
            p = read_problem(path)
        perms = np.array(list(itertools.permutations(range(p.objcnt))))
        out = make_lex_kernel(p, device="cpu")(np.tile(p.initial_rhs(), (len(perms), 1)), perms)
        return p, np.unique(out[1].numpy(), axis=0).astype(np.float64)
    p = read_problem(os.path.join(EX, f"{name}.lp"))
    gold = []
    with open(os.path.join(EX, f"{name}.out")) as fh:
        for line in fh:
            parts = line.split()
            if parts and all(t.lstrip("-").isdigit() for t in parts):
                gold.append([float(t) for t in parts])
    return p, np.array(gold)


def lex_case(name, lanes, seed):
    """``lanes`` lex requests of ``name`` (``lex_problem``): the initial rhs
    and its points moved by -1..1, each under a random ordering."""
    rng = np.random.default_rng(seed)
    p, gold = lex_problem(name)
    k = p.objcnt
    rhs = np.array([
        p.initial_rhs() if b == 0 else gold[rng.integers(len(gold))] + rng.integers(-1, 2, size=k)
        for b in range(lanes)
    ])
    perm = np.array([rng.permutation(k) for _ in range(lanes)])
    return p, rhs, perm


def lex_outputs(kern, out):
    """A lex kernel call's status, results and IPs, then each lane's nodes
    and LP steps, as numpy arrays."""
    return [t.cpu().numpy() for t in out] + [
        kern.lane_nodes.cpu().numpy(), kern.lane_iters.cpu().numpy()
    ]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "name,lanes,max_nodes_stack",
    [("G2AP05", 32, 160), ("G3AP05", 32, 160), ("G3KP10", 5, 160), ("G3KP10", 32, 4),
     ("KP6x12", 8, 160), ("KP12x8", 6, 160), ("KP16x10", 3, 160)],
    ids=["G2AP05", "G3AP05", "G3KP10", "G3KP10-stack4", "KP6x12", "KP12x8", "KP16x10"],
)
def test_lex_kernel_on_the_card_equals_the_cpu(cuda_device, name, lanes, max_nodes_stack):
    """The lex kernel on the card is one launch of K6 a call and no K5
    launch: twice in a row it gives the CPU's statuses, results, IPs and
    each lane's nodes and LP steps (the stack of 4: lanes that overflow
    it), its results stay on the card, and its counters are the CPU's sums
    with no lockstep step and no host read."""
    from moip_aira_tpu_torch.solver.cuda_lp import LAUNCHES
    from moip_aira_tpu_torch.solver.lex_torch import LEX_RESOURCE, make_lex_kernel

    p, rhs, perm = lex_case(name, lanes, seed=3)
    cpu = make_lex_kernel(p, max_nodes_stack=max_nodes_stack, device="cpu")
    want = lex_outputs(cpu, cpu(rhs, perm))
    kern = make_lex_kernel(p, max_nodes_stack=max_nodes_stack, device=cuda_device)
    k5, k6 = LAUNCHES["simplex_dense"], LAUNCHES["lex_bnb"]
    for _ in range(2):
        out = kern(rhs, perm)
        assert all(t.is_cuda for t in out)
        for a, b in zip(lex_outputs(kern, out), want):
            assert np.array_equal(a, b)
    assert kern.launches == LAUNCHES["lex_bnb"] - k6 == 2
    assert LAUNCHES["simplex_dense"] == k5 and kern.lp is None
    # G3KP10's 4 x 14 LPs and the generated knapsacks' fit a warp's
    # registers, one column a thread: K6's regs shape; the assignments' 37
    # and 38 columns a block's registers, two warps: K6's regs_block
    assert kern.plan_launches == ({("regs_block", 1, 1): 2} if "AP" in name
                                  else {("regs", 1, 4): 2})
    assert kern.host_syncs == 0
    assert not any(hasattr(kern, a) for a in ("bnb_steps", "lp_steps", "lane_pivots"))
    assert (kern.nodes, kern.iters) == (2 * cpu.nodes, 2 * cpu.iters)
    assert (kern.path_nodes, kern.path_iters) == (2 * cpu.path_nodes, 2 * cpu.path_iters)
    assert ((want[0] == LEX_RESOURCE).any()) == (max_nodes_stack == 4)


#: the every-plan cases: (instance, lanes, limits of make_lex_kernel); the
#: limits stop lanes (LEX_RESOURCE) on each of the lane driver's stop paths,
#: under every engine: the stack's overflow (G2AP05 overflows a stack of 2,
#: not of 4), the node limit and the LP's step limit (ITER_LIMIT)
EVERY_PLAN_CASES = {
    "G2AP05-12": ("G2AP05", 12, {}), "G3AP05-12": ("G3AP05", 12, {}),
    "G3KP10-6": ("G3KP10", 6, {}), "KP6x12-6": ("KP6x12", 6, {}), "KP12x8-6": ("KP12x8", 6, {}),
    "2AP20-8": ("2AP20", 8, {}), "2AP40-2": ("2AP40", 2, {}),
    "G2AP05-12-stack2": ("G2AP05", 12, {"max_nodes_stack": 2}),
    "2AP20-8-stack4": ("2AP20", 8, {"max_nodes_stack": 4}),
    "G2AP05-12-nodes3": ("G2AP05", 12, {"max_bnb_nodes": 3}),
    "2AP20-8-nodes8": ("2AP20", 8, {"max_bnb_nodes": 8}),
    "G3KP10-6-nodes50": ("G3KP10", 6, {"max_bnb_nodes": 50}),
    "G2AP05-12-iters24": ("G2AP05", 12, {"lp_max_iters": 24}),
    "2AP20-8-iters110": ("2AP20", 8, {"lp_max_iters": 110}),
    "G3KP10-6-iters10": ("G3KP10", 6, {"lp_max_iters": 10}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name,lanes,limits", list(EVERY_PLAN_CASES.values()),
                         ids=list(EVERY_PLAN_CASES))
def test_lex_kernel_every_plan_equals_the_cpu(cuda_device, name, lanes, limits):
    """K6 forced into every plan that fits (``cuda_lex.lex_plans``: a warp a
    lane at P = 1, 2, 4 and 8 in shared memory, and in registers where the
    LP has at most 16 rows and 32 columns, a block of warps with the LP in
    registers where it has at most 32 rows and 33 to 128 columns, a block,
    clusters of 2 and 4 with the tableau in shared and in global memory, at
    2AP40 global clusters of 2, 4 and 8): every output of every lane,
    counts included, equal to the CPU's, each plan one launch, also where
    ``limits`` stop lanes through the lane driver's overflow, node-limit
    and ITER_LIMIT paths under each plan's engine; a plan that fits K5 but
    not K6 raises before launching."""
    from dataclasses import replace

    from moip_aira_tpu_torch.solver import cuda_lex
    from moip_aira_tpu_torch.solver.cuda_lp import LAUNCHES
    from moip_aira_tpu_torch.solver.lex_torch import LEX_RESOURCE, make_lex_kernel

    p, rhs, perm = lex_case(name, lanes, seed=5)
    cpu = make_lex_kernel(p, device="cpu", **limits)
    want = lex_outputs(cpu, cpu(rhs, perm))
    assert not limits or (want[0] == LEX_RESOURCE).any()
    kern = make_lex_kernel(p, device=cuda_device, **limits)
    args = [torch.as_tensor(rhs, device=cuda_device), torch.as_tensor(perm, device=cuda_device)]
    plans = cuda_lex.lex_plans(kern.W)
    assert {q.shape for q in plans} == {
        "2AP20": {"block", "cluster", "global"}, "2AP40": {"global"},
        "G2AP05": {"packed", "block", "regs_block"}, "G3AP05": {"packed", "block", "regs_block"},
    }.get(name, {"packed", "block", "regs"})
    if name == "2AP40":
        assert {q.C for q in plans} == {2, 4, 8}

    def launch(plan):
        cpu_lp = cpu.lp  # the plain loop's LP solver: K6 runs its defaults
        return cuda_lex.launch_lex_bnb(
            kern.W, *args, kern.C, kern.lb, kern.ub, kern.row_lb, kern.row_ub, kern.is_int,
            kern.obj_integral, kern.is_min, kern.maxn, kern.max_bnb_nodes, cpu_lp.max_iters,
            cpu_lp.feas_tol, cpu_lp.cost_tol, cpu_lp.pivot_tol, cpu_lp.progress_tol,
            cpu_lp.stall_limit, plan=plan,
        )

    for plan in plans:
        k6 = LAUNCHES["lex_bnb"]
        out = launch(plan)
        torch.cuda.synchronize()
        got = [t.cpu().numpy() for t in out]
        for a, b, f in zip(got, want, out._fields):
            assert np.array_equal(a, b), (plan, f)
        assert LAUNCHES["lex_bnb"] - k6 == 1
    if name == "2AP40":
        k6 = LAUNCHES["lex_bnb"]
        with pytest.raises(RuntimeError):  # K5's pick, 181,792 bytes, and K6's rows
            launch(replace(plans[-1], shape="cluster"))
        assert LAUNCHES["lex_bnb"] == k6


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(4, 10), (6, 20), (12, 16), (16, 16), (1, 0)],
                         ids=["rows4-cols16", "rows8-cols32", "rows16-cols32", "rows16-full",
                              "rows4-one"])
def test_lex_regs_kernel_spills_nothing(cuda_device, m, n):
    """Each build of K6's regs shape (one column a thread; its arrays of
    4, 8 or 16 rows) keeps its LP in registers: no local byte, at most 255
    registers a thread; an LP past 16 rows or 32 columns has no build."""
    from moip_aira_tpu_torch.solver import cuda_lex

    regs, local = cuda_lex.regs_plan(m, n).kernel_attrs()
    assert 0 < regs <= 255 and local == 0
    with pytest.raises(RuntimeError):
        cuda_lex.LexPlan(m, 33, cuda_lex.F64, "regs", 1, 128, 4).kernel_attrs()


def ap3x10_case():
    """A 3AP10 lex batch (3-objective assignment, n = 10: LPs of 23 rows and
    123 columns, ``utils.generate.ap_lp`` seed 1, the benchmark's
    ``instances.ap_lp`` arithmetic): the initial rhs, then rhs that bound
    some objectives between 30 and 89, each under a random ordering; the
    CPU's plain loop with a cap of 60 B&B nodes a stage (some lanes stop
    there: LEX_RESOURCE), a few seconds."""
    import tempfile

    from moip_aira_tpu_torch.solver.lex_torch import make_lex_kernel
    from moip_aira_tpu_torch.utils.generate import ap_lp

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "AP3x10.lp")
        with open(path, "w") as fh:
            fh.write(ap_lp(10, 3, 1))
        p = read_problem(path)
    rng = np.random.default_rng(3)
    rhs = np.array([
        p.initial_rhs() if b == 0
        else np.where(rng.random(3) < 0.4, np.inf, rng.integers(30, 90, size=3))
        for b in range(8)
    ])
    perm = np.array([rng.permutation(3) for _ in range(8)])
    cpu = make_lex_kernel(p, max_bnb_nodes=60, device="cpu")
    return p, rhs, perm, cpu, lex_outputs(cpu, cpu(rhs, perm))


@pytest.mark.cuda
def test_lex_kernel_3ap10_every_plan_equals_the_cpu(cuda_device):
    """3AP10's 23 x 123 LPs take K6's regs_block (a block of four warps, a
    window of 32 columns each) through the kernel's own plan, and every
    plan that fits (regs_block; a warp a lane at P = 1, 2 and 4, the
    shared bytes of 8 lanes past an H100's; a block; a cluster of 2 with
    the tableau in shared and in global memory)
    gives every lane's status, results, IPs, nodes and LP steps
    equal to the CPU's plain loop, node cap included."""
    from moip_aira_tpu_torch.solver import cuda_lex
    from moip_aira_tpu_torch.solver.lex_torch import LEX_OPTIMAL, LEX_RESOURCE, make_lex_kernel

    p, rhs, perm, cpu, want = ap3x10_case()
    assert {LEX_OPTIMAL, LEX_RESOURCE} <= set(want[0].tolist())
    kern = make_lex_kernel(p, max_bnb_nodes=60, device=cuda_device)
    for a, b in zip(lex_outputs(kern, kern(rhs, perm)), want):
        assert np.array_equal(a, b)
    assert kern.plan_launches == {("regs_block", 1, 1): 1}
    plans = cuda_lex.lex_plans(kern.W)
    assert {("regs_block", 1, 1), ("packed", 1, 1), ("packed", 1, 4), ("block", 1, 1),
            ("cluster", 2, 1)} <= {(q.shape, q.C, q.P) for q in plans}
    args = [torch.as_tensor(rhs, device=cuda_device), torch.as_tensor(perm, device=cuda_device)]
    for plan in plans:
        out = cuda_lex.launch_lex_bnb(
            kern.W, *args, kern.C, kern.lb, kern.ub, kern.row_lb, kern.row_ub, kern.is_int,
            kern.obj_integral, kern.is_min, kern.maxn, kern.max_bnb_nodes, cpu.lp.max_iters,
            cpu.lp.feas_tol, cpu.lp.cost_tol, cpu.lp.pivot_tol, cpu.lp.progress_tol,
            cpu.lp.stall_limit, plan=plan,
        )
        torch.cuda.synchronize()
        for a, b, f in zip([t.cpu().numpy() for t in out], want, out._fields):
            assert np.array_equal(a, b), (plan, f)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(23, 100), (12, 25), (24, 104), (32, 1), (32, 96)],
                         ids=["rows24-3ap10", "rows24-g2ap05", "rows24-cols128", "rows32-cols33",
                              "rows32-cols128"])
def test_lex_regs_block_kernel_spills_nothing(cuda_device, m, n):
    """Each build of K6's regs_block shape (one column a thread, a row a
    warp lane; its arrays of 24 or 32 rows) keeps its LP in registers: no
    local byte, at most 255 registers a thread; an LP past 32 rows or 128
    columns, or of 32 columns or fewer, has no build."""
    from moip_aira_tpu_torch.solver import cuda_lex
    from moip_aira_tpu_torch.solver.cuda_dense import windows

    regs, local = cuda_lex.regs_block_plan(m, n).kernel_attrs()
    assert 0 < regs <= 255 and local == 0
    for bm, bn in ((m, 129 - m), (33, n), (m, 32 - m) if m < 32 else (1, 31)):
        bad = cuda_lex.LexPlan(bm, bm + bn, cuda_lex.F64, "regs_block", 1,
                               32 * windows(bm + bn), 1)
        with pytest.raises(RuntimeError):
            bad.kernel_attrs()


@pytest.mark.cuda
def test_lex_kernel_on_the_card_refuses_a_bad_perm_lane_by_lane(cuda_device):
    """A perm already on the card that names an objective outside [0, k)
    is not read on the host: K6 gives each such lane ``LEX_BAD_PERM``, no
    IP, node or LP step and zero results, in every plan, and every other
    lane what the CPU gives it; no read goes past the objectives."""
    from moip_aira_tpu_torch.solver import cuda_lex
    from moip_aira_tpu_torch.solver.lex_torch import LEX_BAD_PERM, make_lex_kernel

    for name in ("G3KP10", "G3AP05", "2AP20"):
        p, rhs, perm = lex_case(name, 6, seed=7)
        k = p.objcnt
        bad = perm.copy()
        bad[1, 0], bad[4, k - 1] = k, -1
        ok = np.array([0, 2, 3, 5])
        cpu = make_lex_kernel(p, device="cpu")
        want = lex_outputs(cpu, cpu(rhs[ok], perm[ok]))
        kern = make_lex_kernel(p, device=cuda_device)
        out = kern(rhs, torch.as_tensor(bad, device=cuda_device))
        got = lex_outputs(kern, out)
        for g, w in zip(got, want):
            assert np.array_equal(g[ok], w)
        for lane in (1, 4):
            assert got[0][lane] == LEX_BAD_PERM
            assert got[2][lane] == got[3][lane] == got[4][lane] == 0
            assert not got[1][lane].any()
        assert kern.launches == 1
        for plan in cuda_lex.lex_plans(kern.W):
            o = cuda_lex.launch_lex_bnb(
                kern.W, torch.as_tensor(rhs, device=cuda_device),
                torch.as_tensor(bad, device=cuda_device), kern.C, kern.lb, kern.ub,
                kern.row_lb, kern.row_ub, kern.is_int, kern.obj_integral, kern.is_min,
                kern.maxn, kern.max_bnb_nodes, cpu.lp.max_iters, cpu.lp.feas_tol,
                cpu.lp.cost_tol, cpu.lp.pivot_tol, cpu.lp.progress_tol, cpu.lp.stall_limit,
                plan=plan,
            )
            torch.cuda.synchronize()
            assert np.array_equal(o.status.cpu().numpy(), got[0]), plan
            assert np.array_equal(o.nodes.cpu().numpy(), got[3]), plan


@pytest.mark.cuda
def test_make_mesh_gives_one_domain_a_card(cuda_device):
    from moip_aira_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(8)
    cards = torch.cuda.device_count()
    assert mesh.size == min(8, cards)
    assert mesh.domain_devices() == [torch.device("cuda", i) for i in range(mesh.size)]
    assert make_mesh(1).domain_devices() == [torch.device("cuda", 0)]


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs (torch.cuda.device_count() < 2)")
    return torch.device("cuda", 0), torch.device("cuda", 1)


@pytest.mark.cuda
def test_k1_and_k3_raise_their_shared_memory_on_every_card(two_cards):
    """K1 (block and cluster shapes at 2AP20) and K3 (2AP20, F=32, W in
    shared memory) launched on cuda:1 after cuda:0: a kernel's shared-memory
    limit belongs to one card, so each card raises its own, and the second
    card's launches run bit for bit with the plain version."""
    from moip_aira_tpu_torch.solver.bb_torch import fragment_batch_ref
    from moip_aira_tpu_torch.solver.cuda_bb import make_cuda_bb_batch
    from moip_aira_tpu_torch.solver.cuda_lp import dense_plan_for

    count = 13
    for dev in two_cards:
        t, args = lanes("2AP20.lp", dev, seed=5, count=count)
        k1 = make_cuda_lp_batch(t.W_dev, dev)
        m, nc = t.W_dev.shape
        smem, _ = k1.device_limits
        wb = torch.full((count, m), -1, dtype=torch.int32, device=dev)
        wa = torch.zeros((count, nc), dtype=torch.int32, device=dev)
        for shape, C in (("block", 1), ("cluster", 4)):
            plan = dense_plan_for(m, nc - m, shape, C, smem)
            out = k1.run(*args, wb, wa, plan)
            ref = st.dense_lp_batch_ref(k1.W, *args, wb, wa)
            torch.cuda.synchronize(dev)
            assert out.status.device == dev
            for f in out._fields:
                assert torch.equal(getattr(out, f), getattr(ref, f)), (dev, plan, f)
        assert k1.launches == 2

        p, t, c, lo, hi, par = fragment_lanes("2AP20.lp", dev, 16, seed=7)
        par[:, 2] = 32
        node_iters = max(200, 6 * m)
        fn, _ = make_cuda_bb_batch(
            t.W_dev, p.is_int, dev, F=32, D=128, node_iters=node_iters, max_ticks=8192
        )
        assert fn.plan(16).w_smem
        out = fn(c, lo, hi, par)
        wbx = torch.full((16, m), -1, dtype=torch.int32, device=dev)
        wax = torch.zeros((16, nc), dtype=torch.int32, device=dev)
        ref = fragment_batch_ref(
            fn.W, p.is_int, c, lo, hi, par, wbx, wax, F=32, D=128,
            node_iters=node_iters, max_ticks=8192,
        )
        torch.cuda.synchronize(dev)
        for f in ref._fields:
            assert torch.equal(out[f], getattr(ref, f)), (dev, f)
        assert fn.launches == 1 and int(out["nlog"].sum()) > 16


@pytest.mark.cuda
@pytest.mark.parametrize("fragments", [False, True], ids=["per-lp", "fragments"])
def test_wave_over_a_mesh_of_the_card_and_the_host(cuda_device, fragments):
    """G3AP05, 6 workers, 8 domains alternating over the card and the CPU:
    each wave's lanes split between K1 (or K3) on the card and the plain
    version on the CPU, with the CPU-only mesh's front and counts (the
    reference's on 8 devices) and lanes on both devices."""
    from moip_aira_tpu_torch.api import solve_front
    from moip_aira_tpu_torch.parallel.mesh import make_mesh
    from moip_aira_tpu_torch.solver.wave import WaveLexBackend

    p = read_problem(os.path.join(EX, "G3AP05.lp"))
    cpu = torch.device("cpu")
    runs = []
    for devs in ([cpu] * 8, [cuda_device, cpu] * 4):
        be = WaveLexBackend(
            p, device=devs[0], mesh=make_mesh(8, devices=devs), fragments=fragments
        )
        front = solve_front(
            p, n_workers=6, backend=be, device=devs[0], mesh_devices=8, dp="off"
        )
        runs.append((be, front))
    (be0, f0), (be1, f1) = runs
    assert np.array_equal(f1.points, f0.points)
    assert (f1.ip_count, f1.rounds, f1.domain_ips, f1.pre_ips) == (
        118, 10, [19, 13, 7, 14, 13, 9], 43
    )
    for key in ("device_waves", "lp_count", "verify_fallbacks"):
        assert getattr(be1, key) == getattr(be0, key), key
    if fragments:
        for key in ("records", "host_recs", "reopened", "lanes"):
            assert be1.frag_stats[key] == be0.frag_stats[key], key
    st1 = f1.backend_stats
    card = str(cuda_device)
    assert st1["device_lanes"][card] > 0 and st1["device_lanes"]["cpu"] > 0
    # the card takes the first lanes of every wave; the CPU launches nothing
    assert st1["device_launches"] == {card: be1.device_waves, "cpu": 0}
    assert st1["kernel_launches"] == be1.device_waves


@pytest.mark.cuda
def test_distributed_round_over_two_cards_equals_one_card(two_cards):
    """The lex kernel's distributed round with a domain on each card (a lex
    kernel, and its K6 launch, on each) gives the round of the same mesh on
    one card."""
    from moip_aira_tpu_torch.parallel.mesh import make_distributed_round, make_mesh

    p = read_problem(os.path.join(EX, "G2AP05.lp"))
    k = p.objcnt
    outs = []
    for devs in ([two_cards[0]] * 2, list(two_cards)):
        step, n = make_distributed_round(p, make_mesh(2, devices=devs))
        rhs = np.tile(p.initial_rhs(), (n, 1))
        perm = np.array([list(range(k))[:: 1 if i % 2 == 0 else -1] for i in range(n)])
        outs.append([t.cpu().numpy() for t in step(rhs, perm)])
    for a, b in zip(*outs):
        assert np.array_equal(a, b)
    assert (outs[1][0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("name,count", [("G2AP05.lp", 21), ("2AP20.lp", 37)])
def test_xla_engine_launches_k5_once_a_call(cuda_device, name, count):
    """The wave's XLA engine on the card is one launch of K5 a call, with
    one host read: twice in a row a call gives the CPU's outputs and loop
    steps bit for bit, and its outputs stay on the card."""
    from moip_aira_tpu_torch.solver.cuda_lp import LAUNCHES
    from moip_aira_tpu_torch.solver.xla_lp import XlaLPBatch

    t, args = lanes(name, cuda_device, seed=7, count=count, scaled=False)
    card = XlaLPBatch(t.W_np, cuda_device)
    cpu = XlaLPBatch(t.W_np, "cpu")
    want = cpu(*(a.cpu() for a in args))
    k5 = LAUNCHES["simplex_dense"]
    for _ in range(2):
        got = card(*args)
        for f in got._fields:
            assert getattr(got, f).is_cuda
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    assert card.launches == 2 and LAUNCHES["simplex_dense"] - k5 == 2
    assert card.steps == 2 * cpu.steps > 0 and card.syncs == 2


def golden_points(name):
    with open(os.path.join(EX, f"{name}.out")) as fh:
        return [
            [int(t) for t in line.split()] for line in fh
            if line.split() and all(t.lstrip("-").isdigit() for t in line.split())
        ]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_xla_engine_front_on_the_card(cuda_device, dtype):
    """G3AP05 through the scheduler on the XLA engine: the golden front on
    the card with K5 launched once a wave and no other kernel, and the
    CPU's IPs, waves, LPs, re-solves and LP steps (K5 pivots as the CPU
    does)."""
    from moip_aira_tpu_torch.api import solve_front
    from moip_aira_tpu_torch.solver.cuda_lp import LAUNCHES, reset_launches
    from moip_aira_tpu_torch.solver.wave import WaveLexBackend

    p = read_problem(os.path.join(EX, "G3AP05.lp"))
    counts = {}
    for dev in (cuda_device, torch.device("cpu")):
        be = WaveLexBackend(p, device=dev, engine="xla", dtype=dtype)
        reset_launches()
        front = solve_front(p, n_workers=2, backend=be, device=dev, dp="off")
        k5 = LAUNCHES["simplex_dense"]
        assert not any(v for k, v in LAUNCHES.items() if k != "simplex_dense")
        assert front.points.tolist() == golden_points("G3AP05")
        st = front.backend_stats
        assert "graphs" not in st
        assert be.lp_kernel.W.device.type == dev.type
        if dev.type == "cuda":
            assert k5 == st["kernel_launches"] == be.device_waves > 0
        else:
            assert k5 == st["kernel_launches"] == 0
        counts[dev.type] = (front.ip_count, be.device_waves, be.lp_count,
                            be.verify_fallbacks, st["lp_steps"])
    assert counts["cuda"] == counts["cpu"]


@pytest.mark.cuda
def test_xla_engine_g2ap05_front_keeps_the_cpu_counts(cuda_device):
    """The fault K5 repairs: with PyTorch's CUDA addcmul, which rounds its
    product, the XLA engine's float32 G2AP05 front at the smoke's widths
    took 16 waves / 96 LPs / 0 re-solves on the card against 19 / 98 / 0 on
    the CPU and in the reference.  On K5 the card gives the CPU's counts."""
    from moip_aira_tpu_torch.api import solve_front
    from moip_aira_tpu_torch.solver.wave import WaveLexBackend

    p = read_problem(os.path.join(EX, "G2AP05.lp"))
    got = {}
    for dev in (cuda_device, torch.device("cpu")):
        be = WaveLexBackend(
            p, device=dev, engine="xla", dtype="float32", batch_width=2048,
            nodes_per_task=32,
        )
        front = solve_front(p, n_workers=2, backend=be, device=dev, dp="off")
        assert front.points.tolist() == golden_points("G2AP05")
        got[dev.type] = (be.device_waves, be.lp_count, be.verify_fallbacks)
    assert got["cuda"] == got["cpu"] == (19, 98, 0)


def dense_case(name, lanes_n, dtype, seed=1):
    """``lanes_n`` LP lanes of ``name`` for the dense simplex on the CPU, as
    tests/test_torch_lex.py builds them: one stage objective a lane, the
    objective rows bounded at a golden point moved by -1..1, a few
    variables fixed; and the system [A; C | -I]."""
    rng = np.random.default_rng(seed)
    p = read_problem(os.path.join(EX, f"{name}.lp"))
    gold = np.array(golden_points(name), dtype=np.float64)
    n, m, k = p.n, p.m_total, p.objcnt
    c, lo, hi = (np.zeros((lanes_n, n + m)) for _ in range(3))
    for b in range(lanes_n):
        c[b, :n] = (1.0 if p.objsen is Sense.MIN else -1.0) * p.C[b % k]
        g = gold[rng.integers(len(gold))] + rng.integers(-1, 2, size=k)
        free = np.full(k, np.inf)
        olo, ohi = (-free, g) if p.objsen is Sense.MIN else (g, free)
        lo[b] = np.concatenate([p.lb, p.row_lb, olo])
        hi[b] = np.concatenate([p.ub, p.row_ub, ohi])
        for v in rng.choice(n, size=int(rng.integers(0, 4)), replace=False):
            fix = float(rng.integers(0, 2))
            if rng.random() < 0.5:
                hi[b, v] = min(hi[b, v], fix)
            else:
                lo[b, v] = max(lo[b, v], fix)
    W = np.hstack([np.vstack([p.A, p.C]), -np.eye(m)])
    return W, [torch.as_tensor(a, dtype=dtype) for a in (c, lo, hi)]


#: K5's cases on the card: the smoke's phase dense-loop shapes (2AP40 on 32
#: of its 256 lanes: the plain loop on the CPU takes minutes at 256; 2AP60,
#: whose slices K5 keeps in global memory, on 4), and the shape the plan
#: picks for each
DENSE_LOOP_CASES = [
    ("G3KP10", 64, "packed"), ("KP2D50", 64, "packed"), ("G2AP05", 64, "packed"),
    ("2AP20", 32, "cluster"), ("2AP40", 32, "cluster"), ("2AP60", 4, "global"),
]


def lex_root_case(lanes_n=32):
    """The lex backend's first LP call on 2AP20: the stage-0 objective of
    each lane over the root box, its objective rows bounded by the initial
    rhs or a golden point, under the identity and the reversed ordering in
    turn (chip_smoke.py's lex batch), in float64."""
    p = read_problem(os.path.join(EX, "2AP20.lp"))
    n, m, k = p.n, p.m_total, p.objcnt
    gold = np.array(golden_points("2AP20"), dtype=np.float64)
    rhs = [p.initial_rhs(), p.initial_rhs()] + [gold[i % len(gold)] for i in range(lanes_n - 2)]
    perm = [list(range(k)), list(range(k))[::-1]] + [
        list(range(k)) if (i // len(gold)) % 2 == 0 else list(range(k))[::-1]
        for i in range(lanes_n - 2)
    ]
    rhs, perm = np.array(rhs), np.array(perm)
    is_min = p.objsen is Sense.MIN
    free = np.full(rhs.shape, np.inf)
    olo, ohi = (-free, rhs) if is_min else (rhs, free)
    c = np.zeros((lanes_n, n + m))
    c[:, :n] = (1.0 if is_min else -1.0) * p.C[perm[:, 0]]
    lo = np.hstack([np.tile(np.concatenate([p.lb, p.row_lb]), (lanes_n, 1)), olo])
    hi = np.hstack([np.tile(np.concatenate([p.ub, p.row_ub]), (lanes_n, 1)), ohi])
    W = np.hstack([np.vstack([p.A, p.C]), -np.eye(m)])
    return W, [torch.as_tensor(a) for a in (c, lo, hi)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name,lanes_n,shape", DENSE_LOOP_CASES)
def test_dense_loop_kernel_matches_plain_bit_for_bit(cuda_device, name, lanes_n, shape, dtype):
    """K5 on the card against DenseLPSolver on the CPU, on the same lanes
    (a third of them inactive), in the plan its wrapper picks: status,
    objective, x, basis, at-upper flags and iterations equal bit for bit on
    every lane, in one launch counted by its plan, and the step count is
    the plain loop's."""
    from moip_aira_tpu_torch.solver.cuda_dense import loop_plan
    from moip_aira_tpu_torch.solver.cuda_lp import LAUNCHES
    from moip_aira_tpu_torch.solver.simplex_dense import DenseLPSolver
    from moip_aira_tpu_torch.solver.xla_lp import F32_TOLERANCES

    W, args = dense_case(name, lanes_n, dtype)
    active = torch.ones(lanes_n, dtype=torch.bool)
    active[2::3] = False
    tol = F32_TOLERANCES if dtype == torch.float32 else {}
    plain = DenseLPSolver(torch.as_tensor(W, dtype=dtype), 2000, **tol)
    want = plain(*args, active=active)
    card = DenseLPSolver(torch.as_tensor(W, dtype=dtype, device=cuda_device), 2000, **tol)
    k5 = LAUNCHES["simplex_dense"]
    got = card(*(a.to(cuda_device) for a in args), active=active.to(cuda_device))
    torch.cuda.synchronize()
    for f in want._fields:
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    assert card.launches == LAUNCHES["simplex_dense"] - k5 == 1
    assert card.steps == plain.steps and card.syncs == 1
    plan = loop_plan(card.W, lanes_n)
    assert plan.shape == shape
    assert card.plan_launches == {(plan.shape, plan.C, plan.P): 1}


@pytest.mark.cuda
@pytest.mark.parametrize(
    "name,lanes_n,dtype",
    [(n, k, dt) for dt in (torch.float32, torch.float64) for n, k, _ in DENSE_LOOP_CASES]
    + [("lex", 32, torch.float64)],
)
def test_dense_loop_every_plan_matches_plain_bit_for_bit(cuda_device, name, lanes_n, dtype):
    """K5 forced into every plan that fits (``cuda_dense.loop_plans``: a
    warp a lane at P = 1, 2, 4 and 8, a block, each cluster size with the
    tableau in shared and in global memory) at the smoke's shapes and at
    the lex batch's root LPs of 2AP20: every output of every lane equal to
    the plain loop's, each plan one launch."""
    from moip_aira_tpu_torch.solver import cuda_dense
    from moip_aira_tpu_torch.solver.cuda_lp import LAUNCHES
    from moip_aira_tpu_torch.solver.simplex_dense import DenseLPSolver
    from moip_aira_tpu_torch.solver.xla_lp import F32_TOLERANCES

    if name == "lex":
        W, args = lex_root_case(lanes_n)
    else:
        W, args = dense_case(name, lanes_n, dtype, seed=3)
    tol = F32_TOLERANCES if dtype == torch.float32 else {}
    plain = DenseLPSolver(torch.as_tensor(W, dtype=dtype), 2000, **tol)
    want = plain(*args)
    W_dev = torch.as_tensor(W, dtype=dtype, device=cuda_device)
    args_dev = [a.to(cuda_device) for a in args]
    plans = cuda_dense.loop_plans(W_dev)
    shapes = {p.shape for p in plans}
    assert shapes == {
        "2AP20": {"block", "cluster", "global"}, "lex": {"block", "cluster", "global"},
        "2AP40": {"cluster", "global"}, "2AP60": {"global"},
    }.get(name, {"packed", "block"})
    for plan in plans:
        k5 = LAUNCHES["simplex_dense"]
        got = cuda_dense.launch_dense_loop(
            W_dev, *args_dev, None, plain.max_iters, plain.feas_tol, plain.cost_tol,
            plain.pivot_tol, plain.progress_tol, plain.stall_limit, plan=plan,
        )
        torch.cuda.synchronize()
        for f in want._fields:
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), (plan, f)
        assert LAUNCHES["simplex_dense"] - k5 == 1


@pytest.mark.cuda
def test_dense_loop_plan_that_does_not_fit_raises_before_launching(cuda_device):
    """A K5 plan whose shape, shared memory, block or cluster the kernel
    cannot take is refused before the launch and raises; nothing is
    counted."""
    from dataclasses import replace

    from moip_aira_tpu_torch.solver import cuda_dense
    from moip_aira_tpu_torch.solver.cuda_lp import LAUNCHES

    W, args = dense_case("2AP40", 4, torch.float64)
    W_dev = torch.as_tensor(W, device=cuda_device)
    args_dev = [a.to(cuda_device) for a in args]
    m, nc = W.shape
    plan = cuda_dense.loop_plan(W_dev, 4)
    assert (plan.shape, plan.C) == ("cluster", 8)
    k5 = LAUNCHES["simplex_dense"]
    for bad in (
        replace(plan, C=4),  # a quarter of the float64 tableau a block: 294 KB
        replace(plan, threads=48),
        replace(plan, C=16),
        replace(plan, shape="global", C=16),
        replace(plan, shape="global", threads=512),
        cuda_dense.DenseLoopPlan(m, nc, 8, "block", 1, 256),  # all of it: 1.1 MB
        cuda_dense.DenseLoopPlan(m, nc, 8, "packed", 1, 128, 4),  # 82 rows on a warp
    ):
        with pytest.raises(RuntimeError):
            cuda_dense.launch_dense_loop(
                W_dev, *args_dev, None, 2000, 1e-9, 1e-9, 1e-9, 1e-12, 60, plan=bad,
            )
    assert LAUNCHES["simplex_dense"] == k5


@pytest.mark.cuda
def test_dense_loop_kernel_refuses_before_launching(cuda_device):
    """No fallback: a CUDA lane of the wrong dtype, shape or device raises,
    and nothing is launched."""
    from moip_aira_tpu_torch.solver.simplex_dense import DenseLPSolver

    W, args = dense_case("G2AP05", 4, torch.float64)
    solver = DenseLPSolver(torch.as_tensor(W, device=cuda_device), 2000)
    c, lo, hi = (a.to(cuda_device) for a in args)
    with pytest.raises(TypeError):
        solver(c.float(), lo, hi)
    with pytest.raises(ValueError):
        solver(c[:, 1:].contiguous(), lo, hi)
    with pytest.raises(ValueError):
        solver(c.cpu(), lo, hi)
    assert solver.launches == 0

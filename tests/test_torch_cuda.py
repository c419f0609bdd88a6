"""K1 and K2, the CUDA kernels, against their plain PyTorch versions on
the card.

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


def lanes(name, dev, seed):
    """B lanes of ``name`` on ``dev``: one stage objective per lane, free
    objective rows, a few integer fixes on the lanes after the first, and
    logical bounds row-scaled as the wave scales them."""
    rng = np.random.default_rng(seed)
    p = read_problem(os.path.join(EX, name))
    t = lp_tensors(p, dev)
    n, m, k = p.n, p.m_total, p.objcnt
    c = np.zeros((B, n + m))
    for b in range(B):
        c[b, :n] = (1.0 if p.objsen is Sense.MIN else -1.0) * p.C[b % k]
    free = np.full(k, np.inf)
    lo = np.tile(np.concatenate([p.lb, p.row_lb, -free]), (B, 1))
    hi = np.tile(np.concatenate([p.ub, p.row_ub, free]), (B, 1))
    for b in range(1, B):
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
    # 2AP40's tableau (82 x 1682, 552 KB) exceeds shared memory: the
    # kernel's global-scratch layout
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
    # the smoke's three shapes: G3KP10 (deep trees, budget stops), 2AP20
    # (all in shared memory), 2AP40 (82 x 1682, about 80 KB of shared
    # memory a lane, a tick stop)
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

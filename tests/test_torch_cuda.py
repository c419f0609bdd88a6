"""K1, the CUDA kernel, against its plain PyTorch version on the card.

Every test here needs an NVIDIA GPU and skips without one.  The file
imports no jax, so on a machine with a card and without jax it runs alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import os

import numpy as np
import pytest
import torch

from moip_aira_tpu.io import read_problem
from moip_aira_tpu.sense import Sense
from moip_aira_tpu_torch.convert import lp_tensors
from moip_aira_tpu_torch.solver import simplex_torch as st
from moip_aira_tpu_torch.solver.cuda_lp import make_cuda_lp_batch

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
    inputs they agree exactly, warm lanes included."""
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

"""The port's copy of the f64 certifier gives exactly the reference's
results on the same wave inputs (device claims from the plain K1 on
row-scaled LPs, certified against the unscaled system)."""

import os

import numpy as np
import pytest
import torch

from moip_aira_tpu.io import read_problem
from moip_aira_tpu.sense import Sense
from moip_aira_tpu.solver.verify import LPVerifier as RefVerifier
from moip_aira_tpu_torch.convert import lp_tensors
from moip_aira_tpu_torch.solver import simplex_torch as st
from moip_aira_tpu_torch.solver.verify import LPVerifier

EX = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
B = 24


def wave_inputs(name, seed):
    """B lanes with random objective-bound caps and branching fixes, solved
    by the plain K1; returns unscaled (c, lo, hi) and the claims."""
    rng = np.random.default_rng(seed)
    p = read_problem(os.path.join(EX, name))
    t = lp_tensors(p, torch.device("cpu"))
    n, m, k = p.n, p.m_total, p.objcnt
    is_min = p.objsen is Sense.MIN
    c = np.zeros((B, n + m))
    lo = np.zeros((B, n + m))
    hi = np.zeros((B, n + m))
    base = np.abs(p.C).sum(axis=1)
    for b in range(B):
        c[b, :n] = (1.0 if is_min else -1.0) * p.C[b % k]
        srhs = np.where(rng.random(k) < 0.5, rng.uniform(0.1, 0.6, k) * base,
                        np.inf if is_min else -np.inf)
        olo, ohi = (np.full(k, -np.inf), srhs) if is_min else (srhs, np.full(k, np.inf))
        lo[b] = np.concatenate([p.lb, p.row_lb, olo])
        hi[b] = np.concatenate([p.ub, p.row_ub, ohi])
        for v in rng.choice(n, size=int(rng.integers(0, 4)), replace=False):
            hi[b, v] = lo[b, v]
    lo_s, hi_s = lo.copy(), hi.copy()
    lo_s[:, n:] *= t.row_scale
    hi_s[:, n:] *= t.row_scale
    out = st.dense_lp_batch_ref(
        t.W_dev, *(torch.as_tensor(a, dtype=torch.float32) for a in (c, lo_s, hi_s)),
        torch.full((B, m), -1, dtype=torch.int32),
        torch.zeros((B, n + m), dtype=torch.int32),
    )
    return t, c, lo, hi, out


@pytest.mark.parametrize("name", ["G2AP05.lp", "G3KP10.lp", "KP2D50.lp"])
@pytest.mark.parametrize("seed", [0, 1])
def test_certificates_match_reference(name, seed):
    t, c, lo, hi, out = wave_inputs(name, seed)
    status = out.status.numpy()
    basis = out.basis.numpy()
    atup = out.at_upper.numpy() > 0
    # exercise every claim kind, including ones the certifier must reject
    status = status.copy()
    status[::7] = st.INFEASIBLE
    mine = LPVerifier(t.W_np).certify(c, lo, hi, status, basis, atup)
    ref = RefVerifier(t.W_np).certify(c, lo, hi, status, basis, atup)
    assert mine.ok.any() and not mine.ok.all()
    for f in ref._fields:
        np.testing.assert_array_equal(getattr(mine, f), getattr(ref, f), err_msg=f)


def test_rejects_at_upper_with_infinite_bound():
    """Soundness: at_upper on an infinite-bound nonbasic column must fail
    certification even when the reduced-cost signs line up."""
    A = np.array([[1.0, 1.0]])
    W = np.hstack([A, -np.eye(1)])
    c = np.array([[-1.0, -2.0, 0.0]])
    lo = np.array([[0.0, 0.0, -np.inf]])
    hi = np.array([[np.inf, np.inf, 10.0]])
    status = np.array([st.OPTIMAL], dtype=np.int32)
    basis = np.array([[2]], dtype=np.int32)
    at_upper = np.array([[True, True, False]])
    cert = LPVerifier(W).certify(c, lo, hi, status, basis, at_upper)
    assert not cert.ok[0]

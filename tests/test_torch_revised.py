"""K2 in the port: the plain PyTorch revised simplex
(``simplex_torch.revised_lp_batch_ref``) against the Pallas kernel
``make_pallas_rev_batch`` in interpret mode and against the port's numpy
oracle, the warm-start contract and K2's wrapper on the CPU (the CUDA kernel
itself: tests/test_torch_cuda.py).

Inputs are made with numpy from fixed seeds and handed to both sides.
Tolerances: f32 objectives of two implementations whose sums run in another
order agree to 1e-3 * max(1, |obj|) (the reference's own f32 tolerance,
tests/test_simplex.py); f64 objectives against the exact oracle to 1e-7.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moip_aira_tpu.solver.pallas_rev import make_pallas_rev_batch
from moip_aira_tpu_torch.solver import simplex_torch as st
from moip_aira_tpu_torch.solver.cuda_lp import make_cuda_rev_batch
from moip_aira_tpu_torch.solver.simplex_np import (
    COST_TOL,
    FEAS_TOL,
    PIVOT_TOL,
    SimplexWorkspace,
    solve_lp,
)
from moip_aira_tpu_torch.solver.status import SolveStatus
from test_torch_simplex import B, cold, f32_close, g2ap05_root, instance_lanes, random_lp, tile

CPU = torch.device("cpu")
ORACLE_TOLS = dict(feas_tol=FEAS_TOL, cost_tol=COST_TOL, pivot_tol=PIVOT_TOL)


def run_pallas_rev(W, c, lo, hi, wb, wa):
    with jax.enable_x64(False):
        fn, _ = make_pallas_rev_batch(np.asarray(W, np.float32), B, interpret=True)
        out = fn(
            *(jnp.asarray(a, jnp.float32) for a in (c, lo, hi)),
            jnp.asarray(wb, jnp.int32), jnp.asarray(wa, jnp.int32),
        )
        return [np.asarray(o) for o in out]


def run_plain(W, c, lo, hi, wb, wa, **kw):
    return st.revised_lp_batch_ref(
        torch.as_tensor(W),
        *(torch.as_tensor(a, dtype=torch.float32) for a in (c, lo, hi)),
        torch.as_tensor(wb), torch.as_tensor(wa), **kw,
    )


def singular_basis(W):
    """A warm basis that is column a in every row, for a column a outside
    row 0: singular, and singular for the reference kernel's rebuild too
    (its greedy pivot leaves an all-zero remainder whose first entry, in
    row 0, is 0)."""
    a = int(np.flatnonzero(np.asarray(W)[0] == 0)[0])
    return np.full(W.shape[0], a, np.int32)


@pytest.mark.parametrize("name", ["G2AP05.lp", "G3KP10.lp", "moip_2_30_knapsack.mop"])
@pytest.mark.parametrize("start", ["cold", "warm", "mixed"])
def test_plain_f32_matches_pallas_rev(name, start):
    rng = np.random.default_rng(7)
    p, t, c, lo, hi = instance_lanes(name, rng)
    W = t.W_dev.numpy()
    m, nc = W.shape
    wb, wa = cold(m, nc)
    if start != "cold":
        # warm lanes start from the bases the kernel's own cold pass found
        ref0 = run_pallas_rev(W, c, lo, hi, wb, wa)
        wb, wa = ref0[3].copy(), ref0[4].copy()
        if start == "mixed":
            wb[1::2] = -1
            wa[1::2] = 0
            wb[3] = singular_basis(W)  # falls back to the cold start
    ref = run_pallas_rev(W, c, lo, hi, wb, wa)
    out = run_plain(W, c, lo, hi, wb, wa)
    np.testing.assert_array_equal(out.status.numpy(), ref[0])
    opt = ref[0] == st.OPTIMAL
    assert opt.any()
    assert f32_close(out.obj.numpy()[opt], ref[1][opt])
    if start == "warm":
        assert (out.iters.numpy() <= 2).all()  # the same LPs, warm
    if start == "mixed":
        cold_out = run_plain(W, c, lo, hi, *cold(m, nc))
        assert out.iters[3] == cold_out.iters[3] > 2
        assert torch.equal(out.basis[3], cold_out.basis[3])


def test_plain_f32_infinite_bounds_keep_their_sentinels():
    """MIN objective rows carry -inf lower bounds and the knapsack .mop has
    +inf upper bounds: the root LP of objective 0 reaches the f64 oracle's
    value, not the origin's."""
    rng = np.random.default_rng(3)
    p, t, c, lo, hi = instance_lanes("moip_2_30_knapsack.mop", rng)
    assert np.isinf(hi[:, : p.n]).any() and np.isinf(lo).any()
    out = run_plain(t.W_dev.numpy(), c, lo, hi, *cold(*t.W_dev.shape))
    assert (out.status == st.OPTIMAL).all()
    ws = SimplexWorkspace(t.A_full)
    lo0, hi0 = lo[0].copy(), hi[0].copy()
    lo0[p.n :] /= t.row_scale
    hi0[p.n :] /= t.row_scale
    oracle = solve_lp(ws, c[0, : p.n], lo0, hi0)
    assert oracle.status == SolveStatus.OPTIMAL and oracle.obj < -1.0
    assert f32_close(out.obj[:1].numpy(), [oracle.obj])


@pytest.mark.parametrize("seed", range(4))
def test_plain_f64_matches_numpy_oracle_random(seed):
    rng = np.random.default_rng(300 + seed)
    for _ in range(8):
        A, c, lo, hi = random_lp(rng, int(rng.integers(2, 7)), 6)
        ws = SimplexWorkspace(A)
        m = A.shape[0]
        ref = solve_lp(ws, c, lo, hi)
        out = st.revised_lp_batch_ref(
            torch.as_tensor(ws.W),
            torch.as_tensor(np.concatenate([c, np.zeros(m)])[None]),
            torch.as_tensor(lo[None]), torch.as_tensor(hi[None]),
            torch.full((1, m), -1, dtype=torch.int32),
            torch.zeros((1, ws.ncols), dtype=torch.int32),
            dtype=torch.float64, **ORACLE_TOLS,
        )
        assert int(out.status[0]) == int(ref.status)
        if ref.status == SolveStatus.OPTIMAL:
            assert abs(out.obj[0].item() - ref.obj) <= 1e-7


@pytest.mark.parametrize("name", ["G2AP05.lp", "G3KP10.lp"])
def test_plain_f64_matches_numpy_oracle_instance(name):
    rng = np.random.default_rng(11)
    p, t, c, lo, hi = instance_lanes(name, rng)
    lo[:, p.n :] /= t.row_scale  # the unscaled f64 system, as the oracle's
    hi[:, p.n :] /= t.row_scale
    ws = SimplexWorkspace(t.A_full)
    wb, wa = cold(*t.W_np.shape)
    out = st.revised_lp_batch_ref(
        torch.as_tensor(t.W_np), *(torch.as_tensor(a) for a in (c, lo, hi)),
        torch.as_tensor(wb), torch.as_tensor(wa),
        dtype=torch.float64, **ORACLE_TOLS,
    )
    for b in range(B):
        ref = solve_lp(ws, c[b, : p.n], lo[b], hi[b])
        assert int(out.status[b]) == int(ref.status)
        if ref.status == SolveStatus.OPTIMAL:
            assert abs(out.obj[b].item() - ref.obj) <= 1e-7


def test_revised_and_dense_plain_versions_take_the_same_pivots():
    """K1 and K2 compute the same pivots in other arithmetic: on G2AP05's
    lanes their plain versions agree on status, basis and pivot counts."""
    rng = np.random.default_rng(9)
    p, t, c, lo, hi = instance_lanes("G2AP05.lp", rng)
    args = [torch.as_tensor(a, dtype=torch.float32) for a in (c, lo, hi)]
    wb, wa = (torch.as_tensor(a) for a in cold(*t.W_dev.shape))
    rev = st.revised_lp_batch_ref(t.W_dev, *args, wb, wa)
    dense = st.dense_lp_batch_ref(t.W_dev, *args, wb, wa)
    for f in ("status", "basis", "at_upper", "iters"):
        assert torch.equal(getattr(rev, f), getattr(dense, f)), f
    assert f32_close(rev.obj.numpy(), dense.obj.numpy())


def test_wrapper_runs_the_plain_version_on_the_cpu():
    """K2's wrapper: warm lanes reproduce the cold optimum in at most two
    iterations, the empty box is infeasible without a pivot, the inputs are
    checked as K1's are, and CPU tensors never count a launch."""
    p, W, c, lo, hi = g2ap05_root()
    m, nc = W.shape
    k2 = make_cuda_rev_batch(W, CPU)
    wb0 = torch.full((8, m), -1, dtype=torch.int32)
    wa0 = torch.zeros((8, nc), dtype=torch.int32)
    r = k2(tile(c), tile(lo), tile(hi), wb0, wa0)
    assert (r.status == st.OPTIMAL).all() and int(r.iters[0]) > 3
    r2 = k2(tile(c), tile(lo), tile(hi), r.basis, r.at_upper)
    assert (r2.status == st.OPTIMAL).all() and (r2.iters <= 2).all()
    assert np.allclose(r2.obj.numpy(), r.obj[0].item(), atol=1e-3)
    lo_e = lo.copy()
    lo_e[3] = hi[3] + 1.0
    r3 = k2(tile(c), tile(lo_e), tile(hi), wb0, wa0)
    assert (r3.status == st.INFEASIBLE).all() and (r3.iters == 0).all()
    with pytest.raises(TypeError):
        k2(tile(c, torch.float64), tile(lo), tile(hi), wb0, wa0)
    with pytest.raises(ValueError):
        k2(tile(c), tile(lo), tile(hi), wb0[:, :-1].contiguous(), wa0)
    assert k2.launches == 0 and k2.kernel == "revised_simplex"

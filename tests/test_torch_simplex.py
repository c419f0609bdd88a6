"""K1 in the port: the plain PyTorch simplex against the Pallas kernel and
the numpy oracle, the warm-start contract, the wrapper's input checks and
the kernel build (the CUDA kernel itself: tests/test_torch_cuda.py).

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

from moip_aira_tpu.io import read_problem
from moip_aira_tpu.sense import Sense
from moip_aira_tpu.solver.pallas_lp import make_pallas_lp_batch
from moip_aira_tpu.solver.simplex_np import (
    COST_TOL,
    FEAS_TOL,
    PIVOT_TOL,
    SimplexWorkspace,
    solve_lp,
)
from moip_aira_tpu.solver.status import SolveStatus
from moip_aira_tpu_torch.convert import lp_tensors
from moip_aira_tpu_torch.solver import simplex_torch as st
from moip_aira_tpu_torch.solver.cuda_lp import make_cuda_lp_batch

EX = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
CPU = torch.device("cpu")
B = 16


def f32_close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.all(np.abs(a - b) <= 1e-3 * np.maximum(1.0, np.abs(b)))


def instance_lanes(name, rng, branched=True):
    """(problem, LPTensors, c, lo, hi) for B lanes of instance ``name``:
    one stage objective per lane, free objective rows, and — on the lanes
    after the first when ``branched`` — a few integer variables fixed at
    one of their bounds.  Logical bounds are row-scaled as the wave does."""
    p = read_problem(os.path.join(EX, name))
    t = lp_tensors(p, CPU)
    n, m, k = p.n, p.m_total, p.objcnt
    sign = 1.0 if p.objsen is Sense.MIN else -1.0
    c = np.zeros((B, n + m))
    for b in range(B):
        c[b, :n] = sign * p.C[b % k]
    free = np.full(k, np.inf)
    olo, ohi = (-free, free)
    lo = np.tile(np.concatenate([p.lb, p.row_lb, olo]), (B, 1))
    hi = np.tile(np.concatenate([p.ub, p.row_ub, ohi]), (B, 1))
    if branched:
        for b in range(1, B):
            for v in rng.choice(n, size=int(rng.integers(1, 4)), replace=False):
                if rng.random() < 0.5 or not np.isfinite(hi[b, v]):
                    hi[b, v] = lo[b, v]
                else:
                    lo[b, v] = hi[b, v]
    lo[:, n:] *= t.row_scale
    hi[:, n:] *= t.row_scale
    return p, t, c, lo, hi


def cold(m, nc):
    return np.full((B, m), -1, np.int32), np.zeros((B, nc), np.int32)


def run_pallas(W, c, lo, hi, wb, wa):
    with jax.enable_x64(False):
        fn, _ = make_pallas_lp_batch(np.asarray(W, np.float32), B, interpret=True)
        out = fn(
            *(jnp.asarray(a, jnp.float32) for a in (c, lo, hi)),
            jnp.asarray(wb, jnp.int32), jnp.asarray(wa, jnp.int32),
        )
        return [np.asarray(o) for o in out]


def run_plain(W, c, lo, hi, wb, wa, **kw):
    return st.dense_lp_batch_ref(
        torch.as_tensor(W),
        *(torch.as_tensor(a, dtype=torch.float32) for a in (c, lo, hi)),
        torch.as_tensor(wb), torch.as_tensor(wa), **kw,
    )


@pytest.mark.parametrize("name", ["G2AP05.lp", "G3KP10.lp"])
@pytest.mark.parametrize("start", ["cold", "warm", "mixed"])
def test_plain_f32_matches_pallas(name, start):
    rng = np.random.default_rng(7)
    p, t, c, lo, hi = instance_lanes(name, rng)
    W = t.W_dev.numpy()
    m, nc = W.shape
    wb, wa = cold(m, nc)
    if start != "cold":
        # warm lanes start from the bases the kernel's own cold pass found
        ref0 = run_pallas(W, c, lo, hi, wb, wa)
        wb, wa = ref0[3].copy(), ref0[4].copy()
        if start == "mixed":
            wb[1::2] = -1
            wa[1::2] = 0
    ref = run_pallas(W, c, lo, hi, wb, wa)
    out = run_plain(W, c, lo, hi, wb, wa)
    np.testing.assert_array_equal(out.status.numpy(), ref[0])
    opt = ref[0] == st.OPTIMAL
    assert opt.any()
    assert f32_close(out.obj.numpy()[opt], ref[1][opt])


def test_plain_f32_infinite_upper_bounds_matches_pallas():
    """A variable with an infinite upper bound entering the basis keeps that
    bound infinite in the pivot row (tests/test_simplex.py:107 guards the
    same regression in the Pallas kernel)."""
    rng = np.random.default_rng(3)
    p, t, c, lo, hi = instance_lanes("moip_2_30_knapsack.mop", rng)
    assert np.isinf(hi[:, : p.n]).any()
    W = t.W_dev.numpy()
    wb, wa = cold(*W.shape)
    ref = run_pallas(W, c, lo, hi, wb, wa)
    out = run_plain(W, c, lo, hi, wb, wa)
    np.testing.assert_array_equal(out.status.numpy(), ref[0])
    assert (ref[0] == st.OPTIMAL).all()
    assert f32_close(out.obj.numpy(), ref[1])
    # lane 0 is the root LP of objective 0: the f64 oracle's value, not the
    # origin's that the old sentinel leak drove the solve back to
    ws = SimplexWorkspace(t.A_full)
    lo0, hi0 = lo[0].copy(), hi[0].copy()
    lo0[p.n :] /= t.row_scale
    hi0[p.n :] /= t.row_scale
    oracle = solve_lp(ws, c[0, : p.n], lo0, hi0)
    assert oracle.status == SolveStatus.OPTIMAL and oracle.obj < -1.0
    assert f32_close(out.obj[:1].numpy(), [oracle.obj])


def random_lp(rng, m, n):
    A = rng.integers(-5, 6, size=(m, n)).astype(float)
    ub = rng.integers(1, 5, size=n).astype(float)
    x0 = rng.uniform(0, 1, size=n) * ub
    act = A @ x0
    row_lb = np.where(rng.random(m) < 0.5, act - rng.integers(0, 4, m), -np.inf)
    row_ub = np.where(rng.random(m) < 0.5, act + rng.integers(0, 4, m), np.inf)
    c = rng.integers(-9, 10, size=n).astype(float)
    lo = np.concatenate([np.zeros(n), row_lb])
    hi = np.concatenate([ub, row_ub])
    return A, c, lo, hi


ORACLE_TOLS = dict(feas_tol=FEAS_TOL, cost_tol=COST_TOL, pivot_tol=PIVOT_TOL)


@pytest.mark.parametrize("seed", range(4))
def test_plain_f64_matches_numpy_oracle_random(seed):
    rng = np.random.default_rng(200 + seed)
    lanes = [random_lp(rng, int(rng.integers(2, 7)), 6) for _ in range(8)]
    for A, c, lo, hi in lanes:
        ws = SimplexWorkspace(A)
        m = A.shape[0]
        ref = solve_lp(ws, c, lo, hi)
        out = st.dense_lp_batch_ref(
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
    # unscaled f64 system, as the oracle sees it
    lo[:, p.n :] /= t.row_scale
    hi[:, p.n :] /= t.row_scale
    ws = SimplexWorkspace(t.A_full)
    wb, wa = cold(*t.W_np.shape)
    out = st.dense_lp_batch_ref(
        torch.as_tensor(t.W_np), *(torch.as_tensor(a) for a in (c, lo, hi)),
        torch.as_tensor(wb), torch.as_tensor(wa),
        dtype=torch.float64, **ORACLE_TOLS,
    )
    for b in range(B):
        ref = solve_lp(ws, c[b, : p.n], lo[b], hi[b])
        assert int(out.status[b]) == int(ref.status)
        if ref.status == SolveStatus.OPTIMAL:
            assert abs(out.obj[b].item() - ref.obj) <= 1e-7


def g2ap05_root():
    p = read_problem(os.path.join(EX, "G2AP05.lp"))
    A_full = np.vstack([p.A, p.C])
    m = A_full.shape[0]
    W = torch.as_tensor(np.hstack([A_full, -np.eye(m)]), dtype=torch.float32)
    lo = np.concatenate([p.lb, p.row_lb, [-np.inf] * p.objcnt])
    hi = np.concatenate([p.ub, p.row_ub, [np.inf] * p.objcnt])
    c = np.concatenate([p.C[0], np.zeros(m)])
    return p, W, c, lo, hi


def tile(a, dtype=torch.float32):
    return torch.as_tensor(np.tile(a, (8, 1)), dtype=dtype).contiguous()


def test_warm_start_basis_rebuild():
    """Warm lanes (basis from a previous solve) reproduce the cold optimum
    through the Gauss-Jordan rebuild in far fewer pivots — also on a child
    with a tightened bound, and in a wave that mixes warm and cold lanes
    (the warm-start properties of tests/test_simplex.py:137-198)."""
    p, W, c, lo, hi = g2ap05_root()
    m, nc = W.shape
    k1 = make_cuda_lp_batch(W, CPU)
    wb0 = torch.full((8, m), -1, dtype=torch.int32)
    wa0 = torch.zeros((8, nc), dtype=torch.int32)
    r = k1(tile(c), tile(lo), tile(hi), wb0, wa0)
    assert int(r.status[0]) == st.OPTIMAL
    cold_obj, cold_iters = r.obj[0].item(), int(r.iters[0])
    assert cold_iters > 3  # otherwise the warm claim below is vacuous

    # identical re-solve, warm: optimal again in at most 2 iterations
    r2 = k1(tile(c), tile(lo), tile(hi), r.basis, r.at_upper)
    assert int(r2.status[0]) == st.OPTIMAL
    assert r2.obj[0].item() == pytest.approx(cold_obj, abs=1e-3)
    assert int(r2.iters[0]) <= 2

    # child subproblem: fix the most fractional-ish variable at 0
    xs = r.x[0].numpy()
    j = int(np.argmax(np.minimum(xs[: p.n], 1 - xs[: p.n])))
    hi_c = hi.copy()
    hi_c[j] = 0.0
    r3c = k1(tile(c), tile(lo), tile(hi_c), wb0, wa0)
    r3w = k1(tile(c), tile(lo), tile(hi_c), r.basis, r.at_upper)
    assert int(r3w.status[0]) == int(r3c.status[0])
    if int(r3c.status[0]) == st.OPTIMAL:
        assert r3w.obj[0].item() == pytest.approx(r3c.obj[0].item(), abs=1e-3)
        assert int(r3w.iters[0]) <= int(r3c.iters[0])

    # mixed wave: lanes 0,2,4,6 warm, lanes 1,3,5,7 cold — all agree
    wb_mix = r.basis.clone()
    wa_mix = r.at_upper.clone()
    wb_mix[1::2] = -1
    wa_mix[1::2] = 0
    r4 = k1(tile(c), tile(lo), tile(hi), wb_mix, wa_mix)
    assert (r4.status == st.OPTIMAL).all()
    assert np.allclose(r4.obj.numpy(), cold_obj, atol=1e-3)
    assert k1.launches == 0  # CPU tensors run the plain version, not K1


def test_singular_warm_basis_falls_back_to_cold():
    p, W, c, lo, hi = g2ap05_root()
    m, nc = W.shape
    wb0 = torch.full((8, m), -1, dtype=torch.int32)
    wa0 = torch.zeros((8, nc), dtype=torch.int32)
    r = st.dense_lp_batch_ref(W, tile(c), tile(lo), tile(hi), wb0, wa0)
    bad = torch.zeros((8, m), dtype=torch.int32)  # column 0 in every row
    rb = st.dense_lp_batch_ref(W, tile(c), tile(lo), tile(hi), bad, wa0)
    for f in ("status", "obj", "basis", "iters"):
        assert torch.equal(getattr(rb, f), getattr(r, f)), f


def test_empty_box_is_infeasible_without_pivots():
    p, W, c, lo, hi = g2ap05_root()
    m, nc = W.shape
    lo_e = lo.copy()
    lo_e[3] = hi[3] + 1.0
    r = st.dense_lp_batch_ref(
        W, tile(c), tile(lo_e), tile(hi),
        torch.full((8, m), -1, dtype=torch.int32),
        torch.zeros((8, nc), dtype=torch.int32),
    )
    assert (r.status == st.INFEASIBLE).all()
    assert (r.iters == 0).all()


def test_wrapper_rejects_what_the_kernel_does_not_take():
    p, W, c, lo, hi = g2ap05_root()
    m, nc = W.shape
    k1 = make_cuda_lp_batch(W, CPU)
    wb = torch.full((8, m), -1, dtype=torch.int32)
    wa = torch.zeros((8, nc), dtype=torch.int32)
    with pytest.raises(TypeError):
        k1(tile(c, torch.float64), tile(lo), tile(hi), wb, wa)
    with pytest.raises(ValueError):
        k1(tile(c), tile(lo), tile(hi), wb[:, :-1].contiguous(), wa)
    with pytest.raises(ValueError):
        k1(tile(c).t().contiguous().t(), tile(lo), tile(hi), wb, wa)


def fake_nvcc(tmp_path, body):
    """A stand-in compiler: a shell script that logs each call and runs
    ``body`` with the output path in $OUT."""
    script = tmp_path / "nvcc"
    script.write_text(
        "#!/bin/sh\n"
        f"echo call >> {tmp_path / 'calls'}\n"
        'while [ "$1" != "-o" ]; do shift; done; OUT="$2"\n' + body + "\n"
    )
    script.chmod(0o755)
    return str(script)


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    from moip_aira_tpu_torch.kernels import build as kb

    nvcc = fake_nvcc(tmp_path, 'echo "error: boom" >&2; exit 2')
    monkeypatch.setattr(kb, "find_nvcc", lambda: nvcc)
    monkeypatch.setattr(kb, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="boom"):
        kb.build("dense_simplex")
    assert list((tmp_path / "kernels").iterdir()) == []  # nothing half-built


def test_build_is_keyed_by_source_hash(monkeypatch, tmp_path):
    from moip_aira_tpu_torch.kernels import build as kb

    nvcc = fake_nvcc(tmp_path, 'echo lib > "$OUT"')
    monkeypatch.setattr(kb, "find_nvcc", lambda: nvcc)
    monkeypatch.setattr(kb, "BUILD_DIR", tmp_path / "kernels")
    first = kb.build("dense_simplex")
    again = kb.build("dense_simplex")
    assert first == again and first.exists()
    assert (tmp_path / "calls").read_text().count("call") == 1

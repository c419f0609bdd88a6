"""The knapsack front DP in the port (``moip_aira_tpu_torch/solver/kp_front.py``)
against the JAX package's, on the CPU: detection field for field, the plain
PyTorch version of K4 (``front_torch``/``dp_table_ref``) against the Pallas
kernel in interpret mode, ``front_jax`` and ``front_np``, the ``dp``
routing of ``solve_front``, K4's wrapper on CPU tensors, and the port's copy
of the instance generator (the CUDA kernel itself: tests/test_torch_cuda.py).

Inputs are the bundled instances or made with numpy from fixed seeds and
handed to both sides.  Tolerance 0 everywhere: the DP is exact int32
arithmetic.
"""

import os

import jax
import numpy as np
import pytest
import torch

from moip_aira_tpu.io import read_problem as read_problem_ref
from moip_aira_tpu.solver import kp_front as ref
from moip_aira_tpu.utils import generate as gen_ref
from moip_aira_tpu_torch.api import solve_front
from moip_aira_tpu_torch.io import read_problem
from moip_aira_tpu_torch.solver import kp_front as kf
from moip_aira_tpu_torch.solver.cuda_dp import CudaKPDP
from moip_aira_tpu_torch.utils import generate as gen
from test_torch_api import EX, bundled_front

KP2_FIELDS = ("w", "V", "cap", "negate", "s_axis")


def both_problems(path):
    return read_problem_ref(path), read_problem(path)


def bounded_integer_mop(tmp_path, seed=2):
    """A knapsack .mop with integer variables of upper bound 3: detection
    expands each into binary pseudo-items of multiplicity 1 and 2."""
    path = tmp_path / f"bounded{seed}.mop"
    path.write_text(
        gen_ref.kp_mop(items=8, objectives=2, seed=seed, vlo=3, vhi=15, integer_ub=3)
    )
    return str(path)


@pytest.mark.parametrize(
    "name", ["G2KP50.lp", "2KP100.lp", "moip_2_30_knapsack.mop", "bounded-integer"]
)
def test_detect_kp2_matches_reference(tmp_path, name):
    path = bounded_integer_mop(tmp_path) if name == "bounded-integer" else os.path.join(EX, name)
    p_ref, p = both_problems(path)
    want, got = ref.detect_kp2(p_ref), kf.detect_kp2(p)
    assert want is not None and got is not None
    for field in KP2_FIELDS:
        assert np.array_equal(getattr(got, field), getattr(want, field)), field
    assert got.table_cells == want.table_cells
    if name == "bounded-integer":
        assert got.w.shape[0] > p.n  # the binary split ran


@pytest.mark.parametrize("name", ["G3KP10.lp", "KP2D50.lp", "G2AP05.lp"])
def test_detect_kp2_rejects_what_the_reference_rejects(name):
    p_ref, p = both_problems(os.path.join(EX, name))
    assert ref.detect_kp2(p_ref) is None
    assert kf.detect_kp2(p) is None


def random_kp2(seed, n):
    """A small KP2 as arrays: weights 0-59 (item 0 weighs 0), values 0-99
    (item 1 has s-value 0), capacity half the weight sum, under 512."""
    rng = np.random.default_rng(seed)
    w = rng.integers(1, 60, n)
    w[0] = 0
    V = rng.integers(0, 100, (2, n))
    V[1, 1] = 0
    V[:, 0] = np.maximum(V[:, 0], 1)
    cap = int(w.sum() // 2)
    assert cap < 512
    return dict(w=w.astype(np.int64), V=V.astype(np.int64), cap=cap, negate=False, s_axis=1)


@pytest.mark.parametrize("seed,n", [(1, 8), (0, 12), (2, 16), (3, 16)])
def test_front_torch_matches_pallas_interpret(seed, n):
    """The plain version of K4 gives the Pallas kernel's front, an item of
    weight 0 and one of s-value 0 included."""
    arrays = random_kp2(seed, n)
    with jax.enable_x64(False):  # the Pallas kernel's int32 index arithmetic
        want = ref.front_pallas(ref.KP2(**arrays), interpret=True)
    got = kf.front_torch(kf.KP2(**arrays), "cpu")
    assert np.array_equal(got, want)
    assert got.shape[0] >= 2


def test_front_torch_matches_np_and_jax_on_G2KP50():
    p_ref, p = both_problems(os.path.join(EX, "G2KP50.lp"))
    kp = kf.detect_kp2(p)
    got = kf.front_torch(kp, "cpu")
    kp_ref = ref.detect_kp2(p_ref)
    assert np.array_equal(got, ref.front_np(kp_ref))
    assert np.array_equal(got, ref.front_jax(kp_ref))
    assert np.array_equal(got, kf.front_np(kp))
    assert np.array_equal(got, bundled_front("G2KP50"))


def ping_pong_table(w, b, a, cap, S):
    """K4's formulation in numpy: each item reads one table and writes the
    other, out = max(in, in shifted by (w, a) plus b where reachable)."""
    cur = np.full((cap + 1, S + 1), -1, np.int32)
    cur[:, 0] = 0
    for wi, bi, ai in zip(w, b, a):
        nxt = cur.copy()
        for c in range(wi, cap + 1):
            for s in range(ai, S + 1):
                src = cur[c - wi, s - ai]
                if src >= 0:
                    nxt[c, s] = max(nxt[c, s], src + bi)
        cur = nxt
    return cur


def test_plain_table_equals_kernel_formulation():
    """The plain version's in-place update and K4's ping-pong give the same
    full table: items of weight 0, of s-value 0, and heavier than the
    capacity (which K4 launches and copies) included."""
    rng = np.random.default_rng(11)
    n, cap = 7, 23
    w = rng.integers(0, 9, n)
    w[0], w[-1] = 0, cap + 4
    b = rng.integers(0, 30, n)
    a = rng.integers(0, 6, n)
    a[1] = 0
    S = int(a.sum())
    items = torch.as_tensor(np.stack([w, b, a]).astype(np.int32))
    got = kf.dp_table_ref(items, cap, S)
    assert got.dtype == torch.int32 and tuple(got.shape) == (cap + 1, S + 1)
    assert np.array_equal(got.numpy(), ping_pong_table(w, b, a, cap, S))


def test_solve_front_routes_2KP100_to_the_dp(monkeypatch):
    """dp='auto' with MOIP_DP unset sends 2KP100 (n = 100 >= 80) to the DP,
    as the reference does; dp='off' takes the AIRA engine (kp_bb)."""
    monkeypatch.delenv("MOIP_DP", raising=False)
    p = read_problem(os.path.join(EX, "2KP100.lp"))
    want = bundled_front("2KP100")
    front = solve_front(p, device="cpu")
    assert front.ip_count == 0
    assert front.backend_stats == {
        "backend": "kp_front", "kernel": "kp_dp", "kernel_launches": 0,
        "items": 100, "table_cells": kf.detect_kp2(p).table_cells, "engine": "torch",
    }
    assert np.array_equal(front.points, want)
    off = solve_front(p, device="cpu", dp="off")
    assert off.ip_count > 0 and off.backend_stats["backend"] == "kpbb"
    assert np.array_equal(off.points, want)


def test_dp_on_takes_small_instances_and_auto_leaves_them(monkeypatch):
    """G2KP50 (n = 50) takes the DP only under dp='on'; 'auto' keeps the
    reference's n >= 80 rule and takes kp_bb.  Both give the golden."""
    monkeypatch.delenv("MOIP_DP", raising=False)
    p = read_problem(os.path.join(EX, "G2KP50.lp"))
    want = bundled_front("G2KP50")
    on = solve_front(p, device="cpu", dp="on")
    assert on.ip_count == 0 and on.backend_stats["backend"] == "kp_front"
    assert np.array_equal(on.points, want)
    auto = solve_front(p, device="cpu")
    assert auto.ip_count > 0 and auto.backend_stats["backend"] == "kpbb"
    assert np.array_equal(auto.points, want)


def test_kp2_front_engines():
    p = read_problem(os.path.join(EX, "G2KP50.lp"))
    want = bundled_front("G2KP50")
    for engine in ("numpy", "torch", "auto"):
        stats = {}
        got = kf.kp2_front(p, engine=engine, device="cpu", stats=stats)
        assert np.array_equal(got, want), engine
        assert stats["engine"] == ("numpy" if engine == "numpy" else "torch")
        assert stats["kernel_launches"] == 0
    with pytest.raises(ValueError):
        kf.kp2_front(p, engine="cuda", device="cpu")
    with pytest.raises(ValueError):
        kf.kp2_front(p, engine="pallas", device="cpu")
    # a problem of another family never reaches the engine or the device
    assert kf.kp2_front(read_problem(os.path.join(EX, "G2AP05.lp")), engine="cuda") is None


def test_wrapper_runs_the_plain_version_on_cpu_tensors_and_checks_its_inputs():
    arrays = random_kp2(5, 10)
    kp = kf.KP2(**arrays)
    items = kf.dp_items(kp, "cpu")
    S = kf.value_sum(kp)
    dp = CudaKPDP()
    got = dp(items, kp.cap, S)
    assert torch.equal(got, kf.dp_table_ref(items, kp.cap, S))
    assert dp.launches == 0
    with pytest.raises(TypeError):
        dp(items.long(), kp.cap, S)
    with pytest.raises(ValueError):
        dp(items[:2].contiguous(), kp.cap, S)
    with pytest.raises(ValueError):
        dp(torch.cat([items, items]).t()[:3], kp.cap, S)  # not contiguous
    with pytest.raises(ValueError):
        dp(items, kf.MAX_TABLE_CELLS, 1)


@pytest.mark.parametrize("items,seed", [(10, 1), (50, 1), (100, 7)])
def test_generate_kp_lp_matches_reference(items, seed):
    assert gen.kp_lp(items, 2, seed=seed) == gen_ref.kp_lp(items, 2, seed=seed)


def test_generate_other_families_match_reference():
    assert gen.ap_lp(5, 2, seed=3) == gen_ref.ap_lp(5, 2, seed=3)
    assert gen.kp_lp(20, 2, seed=4, constraints=2) == gen_ref.kp_lp(20, 2, seed=4, constraints=2)
    assert gen.kp_mop(8, 2, seed=5, integer_ub=3) == gen_ref.kp_mop(8, 2, seed=5, integer_ub=3)

"""The order of every operation of the dense simplex (solver/simplex_dense.py)
and the wrapper of K5, its kernel (solver/cuda_dense.py), on the CPU.

The plain loop is K5's plain version.  Its float64 sums follow XLA's CPU
order for ``simplex_jax`` (``xla_sum``, ``xla_dot``, found in the compiled
CPU code of ``jax.jit(jax.vmap(simplex_jax.make_lp_solver(W, 2000)))``: the
float32 rule holds for float64 too), so its outputs equal the reference's
bit for bit (tolerance 0) on the same numpy-seeded lanes; its fused
multiply-adds are PyTorch's CPU ``addcmul``, checked here to round once.
K5 itself needs a card (tests/test_torch_cuda.py); here its launch plan and
its input checks, which run before any launch."""

import os
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moip_aira_tpu.solver import simplex_jax
from moip_aira_tpu_torch.solver import cuda_dense
from moip_aira_tpu_torch.solver.cuda_dense import dense_loop_plan, launch_dense_loop
from moip_aira_tpu_torch.solver.simplex_dense import DenseLPSolver, xla_dot, xla_sum
from moip_aira_tpu_torch.solver.simplex_torch import ITER_LIMIT
from moip_aira_tpu_torch.solver.xla_lp import F32_TOLERANCES
from test_torch_api import REPO, imported_modules
from test_torch_lex import lp_boxes, problems

#: the H100's opt-in shared bytes a block (cudaDevAttrMaxSharedMemoryPerBlockOptin)
H100_SMEM = 232448
BATCHES = [("G3KP10", 64), ("KP2D50", 64), ("G2AP05", 64), ("2AP20", 32)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def system(name):
    _, p = problems(name)
    return p, np.hstack([np.vstack([p.A, p.C]), -np.eye(p.m_total)])


# -- (a) the float64 order ------------------------------------------------------


@pytest.mark.parametrize("L", [1, 4, 12, 32, 33, 42, 64, 442, 1682])
def test_f64_sums_follow_xla(L):
    """xla_sum and xla_dot in float64 against jnp.sum under jit, bit for
    bit, across the window edges: rows of mixed magnitudes, where the order
    shows."""
    rng = np.random.default_rng(100 + L)
    x = rng.standard_normal((8, L)) * rng.choice([1e-8, 1.0, 1e8], (8, L))
    y = rng.standard_normal((8, L))
    want = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=1))(x))
    assert want.dtype == np.float64
    assert np.array_equal(xla_sum(torch.from_numpy(x), 1).numpy(), want)
    want = np.asarray(jax.jit(lambda a, b: jnp.sum(a * b, axis=1))(x, y))
    assert np.array_equal(xla_dot(torch.from_numpy(x), torch.from_numpy(y), 1).numpy(), want)


@pytest.mark.parametrize("name,lanes", BATCHES)
def test_f64_solver_matches_simplex_jax_bit_for_bit(name, lanes):
    """The batches of test_f32_solver_matches_simplex_jax_bit_for_bit in
    float64 at simplex_jax's default tolerances: status, basis, iteration
    count, at-upper flags, x and the objective equal the reference's bit
    for bit on every lane (tolerance 0)."""
    _, W = system(name)
    c, lo, hi = lp_boxes(problems(name)[1], lanes, seed=1)
    ref = jax.jit(jax.vmap(simplex_jax.make_lp_solver(jnp.asarray(W), 2000)))(
        jnp.asarray(c), jnp.asarray(lo), jnp.asarray(hi)
    )
    out = DenseLPSolver(torch.as_tensor(W), 2000)(*(torch.as_tensor(a) for a in (c, lo, hi)))
    for key in ("status", "basis", "iters", "at_upper", "x", "obj"):
        got = getattr(out, key).numpy()
        assert np.array_equal(got, np.asarray(getattr(ref, key)).astype(got.dtype)), key
    assert {0, 1} <= set(out.status.tolist())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_loop_steps_equal_the_largest_iters(dtype):
    """``steps`` grows by the largest ``iters`` of each call (what K5's
    wrapper adds), and ``syncs`` by one a step and one more."""
    p, W = system("G2AP05")
    tol = F32_TOLERANCES if dtype == torch.float32 else {}
    solver = DenseLPSolver(torch.as_tensor(W, dtype=dtype), 2000, **tol)
    active = torch.ones(20, dtype=torch.bool)
    active[3::4] = False
    for seed in (2, 3):
        c, lo, hi = (torch.as_tensor(a, dtype=dtype) for a in lp_boxes(p, 20, seed))
        steps, syncs = solver.steps, solver.syncs
        out = solver(c, lo, hi, active=active)
        largest = int(out.iters.max())
        assert solver.steps - steps == largest > 0
        assert solver.syncs - syncs == largest + 1
        assert (out.status[~active] == 1).all() and (out.iters[~active] == 0).all()
    assert solver.launches == 0


def test_plain_loop_counts_its_pivots():
    """``pivots``: each lane's pivots, at most its ``iters``, less one on
    every lane that stopped on its own (its last step prices and moves
    nothing), and at least the structural columns its basis holds; a
    bound flip is a step but no pivot."""
    p, W = system("2AP20")
    solver = DenseLPSolver(torch.as_tensor(W), 2000)
    assert solver.pivots is None
    out = solver(*(torch.as_tensor(a) for a in lp_boxes(p, 16, seed=4)))
    piv, iters = solver.pivots, out.iters
    assert piv.shape == iters.shape and piv.dtype == torch.int32
    stopped = (out.status != ITER_LIMIT) & (iters > 0)
    assert (piv[stopped] <= iters[stopped] - 1).all() and (piv <= iters).all()
    structural = (out.basis < p.n).sum(1)
    assert (piv >= structural).all() and int(piv.sum()) > 0


@pytest.mark.parametrize(
    "name,lanes,compacts",
    [("G2AP05", 21, False), ("2AP20", 16, True)],  # 444 and 18,564 entries a lane
)
def test_compacted_lanes_step_as_the_uncompacted(monkeypatch, name, lanes, compacts):
    """Stepping only the running lanes (``COMPACT_MIN_ENTRIES``) changes
    no output, step count or pivot count: the same lanes with compaction
    forced (threshold 0), at its default, and off give equal results bit
    for bit, and the default compacts only where the lanes are large."""
    from moip_aira_tpu_torch.solver import simplex_dense

    p, W = system(name)
    args = [torch.as_tensor(a) for a in lp_boxes(p, lanes, seed=5)]
    taken = []
    take = simplex_dense._Lanes.take
    monkeypatch.setattr(
        simplex_dense._Lanes, "take", lambda S, rows: taken.append(len(rows)) or take(S, rows)
    )
    runs = {}
    for label, limit in (("forced", 0), ("default", simplex_dense.COMPACT_MIN_ENTRIES),
                         ("off", 1 << 62)):
        monkeypatch.setattr(simplex_dense, "COMPACT_MIN_ENTRIES", limit)
        taken.clear()
        solver = DenseLPSolver(torch.as_tensor(W), 2000)
        runs[label] = (solver(*args), solver.steps, solver.pivots, len(taken))
    out, steps, pivots, _ = runs["off"]
    assert runs["forced"][3] > 0 and runs["off"][3] == 0
    assert (runs["default"][3] > 0) is compacts
    for label in ("forced", "default"):
        got, got_steps, got_pivots, _ = runs[label]
        for key in out._fields:
            assert torch.equal(getattr(got, key), getattr(out, key)), (label, key)
        assert got_steps == steps > 0 and torch.equal(got_pivots, pivots), label


def _exact(a, b, c, sign):
    return float(Fraction(float(c)) + sign * Fraction(float(a)) * Fraction(float(b)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("L", [14, 37, 442, 1682])
def test_cpu_addcmul_rounds_once(dtype, L):
    """The plain version's fused multiply-adds: PyTorch's CPU ``addcmul``,
    at value 1 (the basic values' step, xla_dot's chains) and -1 (the
    tableau's rank-1 update, broadcast as the solver broadcasts it), equals
    the exact c + a b rounded once on every sampled element, where the
    rounded product plus c differs on many."""
    rng = np.random.default_rng(L)
    a, b, c = (torch.as_tensor(rng.standard_normal((4, L)), dtype=dtype) for _ in range(3))
    got = torch.addcmul(c, a, b)
    rounded = c + a * b
    T = torch.as_tensor(rng.standard_normal((2, 6, L)), dtype=dtype)
    col = torch.as_tensor(rng.standard_normal((2, 6, 1)), dtype=dtype)
    row = torch.as_tensor(rng.standard_normal((2, 1, L)), dtype=dtype)
    upd = T.clone().addcmul_(col, row, value=-1.0)
    cast = float if dtype == torch.float64 else (lambda v: float(np.float32(v)))
    step = max(1, L // 97)
    differs = 0
    for i in range(4):
        for j in range(0, L, step):
            want = cast(_exact(a[i, j], b[i, j], c[i, j], 1))
            assert got[i, j].item() == want, (i, j)
            differs += rounded[i, j].item() != want
    for k in range(2):
        for i in range(6):
            for j in range(0, L, step):
                want = cast(_exact(col[k, i, 0], row[k, 0, j], T[k, i, j], -1))
                assert upd[k, i, j].item() == want, (k, i, j)
    assert differs > 0


# -- (b) K5's launch plan and wrapper -------------------------------------------


#: the clusters of each size C the H100 holds at once under K5's plans
#: (cudaOccupancyMaxActiveClusters; 1: blocks of the block plan), as
#: tools/k5_bench.py --sweep reads them on the card (NVIDIA H100 80GB HBM3)
H100_HELD = {
    ("2AP20", torch.float32): {1: 264, 2: 132, 4: 92},
    ("2AP20", torch.float64): {1: 132, 2: 66, 4: 30},
    ("2AP40", torch.float32): {4: 30, 8: 30},
    ("2AP40", torch.float64): {8: 15},
    ("2AP60", torch.float32): {2: 132, 4: 62, 8: 30},  # its global plans
    ("2AP60", torch.float64): {2: 66, 4: 30, 8: 15},
}
H100_SMS = 132
PACKED = ("packed", 1, 4, 128, "4 x T")


@pytest.mark.parametrize(
    "name,dtype,lanes,want",
    [
        (name, dtype, lanes, PACKED)
        for name in ("G3KP10", "KP2D50", "G2AP05", "G3AP05")
        for dtype in (torch.float32, torch.float64)
        for lanes in (2, 27, 64)
    ]
    + [
        ("2AP20", torch.float32, 1, ("cluster", 4, 1, 160, "T/4")),
        ("2AP20", torch.float32, 32, ("cluster", 4, 1, 160, "T/4")),  # the XLA engine's
        ("2AP20", torch.float32, 256, ("block", 1, 1, 256, "T")),
        ("2AP20", torch.float64, 1, ("cluster", 4, 1, 160, "T/4")),
        ("2AP20", torch.float64, 32, ("cluster", 2, 1, 256, "T/2")),  # the lex batch
        ("2AP20", torch.float64, 256, ("block", 1, 1, 256, "T")),
        ("2AP40", torch.float32, 1, ("cluster", 8, 1, 256, "T/8")),
        ("2AP40", torch.float32, 256, ("cluster", 8, 1, 256, "T/8")),  # the XLA engine's
        ("2AP40", torch.float64, 1, ("cluster", 8, 1, 256, "T/8")),
        ("2AP40", torch.float64, 256, ("cluster", 8, 1, 256, "T/8")),
        # no block of a cluster of 8 holds a slice: the tableau in global memory
        ("2AP60", torch.float32, 8, ("global", 8, 1, 256, "T/8 global")),
        ("2AP60", torch.float32, 32, ("global", 4, 1, 256, "T/4 global")),
        ("2AP60", torch.float64, 8, ("global", 8, 1, 256, "T/8 global")),
        ("2AP60", torch.float64, 32, ("global", 2, 1, 256, "T/2 global")),  # the lex batch
    ],
)
def test_dense_loop_plan_at_the_bundled_shapes(name, dtype, lanes, want):
    """K5's plan at the H100's shared bytes and cluster counts: a warp a
    lane for the tiny LPs, for 2AP20 the largest cluster of which the card
    holds one for every lane (a block a lane past that), clusters of 8 for 2AP40
    in both dtypes (its tableau fits no block, nor in float64 a cluster of
    4), and for 2AP60, whose slice fits no block of a cluster of 8, a
    cluster with its slices in global memory by the same rule; the plan's
    bytes fit the card, and every shape but that last resort keeps the
    tableau in shared memory."""
    _, W = system(name)
    m, nc = W.shape
    held = H100_HELD.get((name, dtype), {})
    plan = dense_loop_plan(m, nc, dtype, lanes, H100_SMEM, H100_SMS, held)
    assert (plan.shape, plan.C, plan.P, plan.threads, plan.layout) == want
    assert plan in cuda_dense.plans_that_fit(m, nc, dtype, H100_SMEM)
    assert plan.dsize == (8 if dtype == torch.float64 else 4)
    assert plan.smem_bytes <= H100_SMEM - 1024
    pitch = plan.slices[0].pitch
    tableau = m * pitch * plan.dsize
    if plan.shape == "global":
        assert plan.scratch_values == plan.C * m * pitch
        assert plan.smem_bytes + tableau == cuda_dense.dense_loop_smem_bytes(
            "cluster", m, nc, plan.C, 1, plan.dsize)
        assert {p.shape for p in cuda_dense.split_plans(m, nc, dtype, H100_SMEM).values()} == {
            "global"}
    else:
        assert plan.smem_bytes > tableau  # the tableau's slice is in it
        assert plan.scratch_values == 0
    assert sum(s.j1 - s.j0 for s in plan.slices) == nc
    if name == "2AP20" and dtype == torch.float64 and plan.shape == "block":
        # the tableau, 42 x 442 float64, and the vectors beside it
        assert plan.smem_bytes == 182288  # 178.0 KB of the 226 KB a block may take


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("C", [1, 2, 4, 8])
@pytest.mark.parametrize("nc", [14, 37, 38, 54, 442, 1682])
def test_cluster_split_of_a_column_sum_is_xla_sum(nc, C, dtype):
    """The cluster's order of an nc-long sum (the objective's nonbasic part
    and the final objective): each block sums its own windows of the padded
    axis (``slice_of``: whole windows, the first at column 32 w -
    pad_low(nc)), each window term by term, and the lead block sums the
    windows' sums in order; bit for bit ``simplex_dense.xla_sum`` on rows of
    mixed magnitudes.  The slices cover the columns once, in order."""
    rng = np.random.default_rng(nc * 10 + C)
    x = torch.as_tensor(
        rng.standard_normal((16, nc)) * rng.choice([1e-8, 1.0, 1e8], (16, nc)), dtype=dtype
    )
    x[0, :5] = -0.0  # a sum of negative zeros keeps its sign only term by term
    lo = cuda_dense.pad_low(nc)
    sums, edge = [], 0
    for r in range(C):
        s = cuda_dense.slice_of(nc, C, r)
        assert s.j0 == edge and s.j1 >= s.j0
        edge = s.j1
        if nc <= 32:
            if s.j1 > s.j0:  # one chain, on the block that holds every column
                acc = x[:, 0].clone()
                for j in range(1, nc):
                    acc = acc + x[:, j]
                sums.append(acc)
            continue
        for w in range(s.w0, s.w1):
            cols = [32 * w + k - lo for k in range(32)]
            assert all(s.j0 <= j < s.j1 for j in cols if 0 <= j < nc)
            terms = [x[:, j] if 0 <= j < nc else torch.zeros_like(x[:, 0]) for j in cols]
            acc = terms[0].clone()
            for t in terms[1:]:
                acc = acc + t
            sums.append(acc)
    assert edge == nc and len(sums) == cuda_dense.items(nc)
    if nc <= 32:
        total = sums[0]
    else:
        total = xla_sum(torch.stack(sums, 1), 1)
    want = xla_sum(x, 1)
    assert torch.equal(total, want) and torch.equal(torch.signbit(total), torch.signbit(want))


@pytest.mark.parametrize(
    "m,nc,dtype,shape",
    [
        (82, 1682, torch.float64, "cluster"),  # 2AP40
        (102, 2602, torch.float32, "cluster"),  # 2AP50
        (102, 2602, torch.float64, "global"),
        (122, 3722, torch.float32, "global"),  # 2AP60
        (162, 6562, torch.float32, "global"),  # 2AP80
        (202, 10202, torch.float32, "global"),  # 2AP100
        (202, 10202, torch.float64, "global"),
    ],
)
def test_dense_loop_plan_takes_global_memory_last(m, nc, dtype, shape):
    """The 2AP ladder past 2AP40: a cluster of 8 keeps its slices in
    shared memory while one block holds a slice (2AP50 in float32);
    after that only ``global`` plans are chosen among, and they fit."""
    plans = cuda_dense.split_plans(m, nc, dtype, H100_SMEM)
    assert {p.shape for p in plans.values()} == {shape}
    assert 8 in plans
    for lanes in (1, 32, 256):
        plan = dense_loop_plan(m, nc, dtype, lanes, H100_SMEM, H100_SMS, {8: 33})
        assert plan.shape == shape and plan.smem_bytes <= H100_SMEM - 1024
    assert {p.shape for p in cuda_dense.plans_that_fit(m, nc, dtype, H100_SMEM)} >= {"global"}


def test_dense_loop_plan_refuses():
    """No plan for a dtype K5 has no build for, for an LP whose vectors
    fit no block of a cluster of 8 even with the tableau in global memory
    (400 rows and 20,000 columns in float64), or for no rows."""
    with pytest.raises(ValueError, match="float32 or float64"):
        dense_loop_plan(42, 442, torch.float16, 32, H100_SMEM, H100_SMS, {})
    with pytest.raises(ValueError, match="shared bytes"):
        dense_loop_plan(400, 20000, torch.float64, 32, H100_SMEM, H100_SMS, {})
    with pytest.raises(ValueError, match="no LP"):
        dense_loop_plan(0, 10, torch.float32, 32, H100_SMEM, H100_SMS, {})
    with pytest.raises(ValueError, match="packs no LP"):
        cuda_dense.loop_plan_for(42, 442, torch.float64, "packed", 1, H100_SMEM)
    with pytest.raises(ValueError, match="takes no cluster"):
        cuda_dense.loop_plan_for(4, 14, torch.float64, "cluster", 2, H100_SMEM)


@pytest.fixture
def no_library(monkeypatch):
    """K5's library must not be loaded: the checks come first."""

    def refuse():
        raise AssertionError("K5 was loaded")

    monkeypatch.setattr(cuda_dense, "_lib", refuse)


def test_wrapper_refuses_before_any_launch(no_library):
    _, W = system("G3KP10")
    solver = DenseLPSolver(torch.as_tensor(W), 2000)
    m, nc = W.shape
    ok = [torch.zeros(3, nc, dtype=torch.float64) for _ in range(3)]
    with pytest.raises(TypeError, match="float64"):
        solver(ok[0].float(), ok[1], ok[2])
    with pytest.raises(ValueError, match="shape"):
        solver(ok[0][:, :-1].contiguous(), ok[1], ok[2])
    with pytest.raises(ValueError, match="lies on meta"):
        solver(ok[0].to("meta"), ok[1], ok[2])
    with pytest.raises(ValueError, match="contiguous"):
        solver(torch.zeros(nc, 3, dtype=torch.float64).t(), ok[1], ok[2])
    with pytest.raises(ValueError, match="active"):
        solver(*ok, active=torch.ones(3, dtype=torch.int32))
    # on a CPU tensor the wrapper of K5 itself refuses: no fallback
    with pytest.raises(ValueError, match="CUDA"):
        launch_dense_loop(solver.W, *ok, None, 2000, 1e-9, 1e-9, 1e-9, 1e-12, 60)
    assert solver.launches == 0


def test_backend_stats_count_k5_launches_by_plan():
    """backend_stats carries K5's launches by (shape, C, P) as sorted
    [shape, C, P, launches] rows: the XLA engine's summed over its devices'
    wrappers (and the lex backend's K6 launches the same way); a CPU run has
    none."""
    from collections import Counter
    from types import SimpleNamespace

    from moip_aira_tpu_torch.api import backend_stats

    lex = SimpleNamespace(
        name="jax", launches=3, plan_launches=Counter({("packed", 1, 4): 3}),
        nodes=9, iters=90, path_nodes=3, path_iters=30,
    )
    st = backend_stats(lex)
    assert st["k6_plans"] == [["packed", 1, 4, 3]] and "k5_plans" not in st
    assert (st["kernel_launches"], st["path_iters"]) == (3, 30)
    kernels = {
        dev: SimpleNamespace(kernel="xla", launches=k, steps=0, syncs=0, plan_launches=plans)
        for dev, k, plans in (
            ("cuda:0", 3, Counter({("cluster", 4, 1): 2, ("cluster", 2, 1): 1})),
            ("cuda:1", 1, Counter({("cluster", 4, 1): 1})),
        )
    }
    wave = SimpleNamespace(name="wave", lp_kernels=kernels, device_lanes={"cuda:0": 5})
    st = backend_stats(wave)
    assert st["kernel_launches"] == 4
    assert st["k5_plans"] == [["cluster", 2, 1, 1], ["cluster", 4, 1, 3]]
    _, W = system("G3KP10")
    solver = DenseLPSolver(torch.as_tensor(W), 2000)
    solver(*(torch.as_tensor(a) for a in lp_boxes(problems("G3KP10")[1], 4, seed=2)))
    assert solver.plan_launches == Counter() and solver.launches == 0


def test_new_files_import_nothing_of_the_jax_package():
    """The static rule of test_port_imports_nothing_of_the_jax_package on
    the files of K5's path and its tools."""
    for rel in (
        "moip_aira_tpu_torch/solver/cuda_dense.py",
        "moip_aira_tpu_torch/solver/cuda_lex.py",
        "moip_aira_tpu_torch/solver/simplex_dense.py",
        "moip_aira_tpu_torch/solver/xla_lp.py",
        "tools/k5_bench.py",
        "tools/lex_bench.py",
        "tools/xla_parity.py",
    ):
        names = imported_modules(os.path.join(REPO, rel))
        tops = {n.split(".")[0] for n in names}
        assert not tops & {"jax", "jaxlib", "moip_aira_tpu"}, (rel, sorted(names))
    assert os.path.exists(os.path.join(REPO, "moip_aira_tpu_torch/csrc/simplex_dense.cu"))

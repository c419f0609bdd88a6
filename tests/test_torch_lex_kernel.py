"""K6's plain version and its launch plan on the CPU.

K6 (csrc/lex_bnb.cu) runs the lex backend's whole batch on the card, each
lane's stages and B&B nodes in one launch; its plain version is
``lex_torch.LexKernel``'s loop on the CPU, which runs every lane of a batch
at once.  Held here, at small sizes: (a) each lane alone gives what it gives
in the batch, counts included (the premise K6 rests on: no lane of the
plain loop reads another); (b) seeded lanes against the JAX package's
``lex_jax`` (status, results and IPs); (c) K6's shared bytes and plan
(solver/cuda_lex.py) in pure Python, against K5's; (d) the counters the
backend reports and the inputs the kernel and its wrapper refuse.  K6
itself runs on the card only (tests/test_torch_cuda.py)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moip_aira_tpu.io import read_problem as ref_read_problem
from moip_aira_tpu.parallel.symgroup import sym_perms
from moip_aira_tpu.solver import lex_jax
from moip_aira_tpu_torch.api import solve_front
from moip_aira_tpu_torch.io import read_problem
from moip_aira_tpu_torch.sense import Sense
from moip_aira_tpu_torch.parallel import mesh
from moip_aira_tpu_torch.solver import cuda_dense, cuda_lex, lex_torch

EX = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
F64 = torch.float64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small batched ops: one intra-op thread is faster than a pool on a
    machine that runs several test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def golden(name):
    rows = []
    with open(f"{EX}/{name}.out") as fh:
        for line in fh:
            parts = line.split()
            if parts and all(p.lstrip("-").isdigit() for p in parts):
                rows.append([int(p) for p in parts])
    return np.array(rows, dtype=np.float64)


def lex_lanes(p, lanes):
    """tests/test_torch_lex.py's lanes: the initial rhs, the golden points
    and the golden points tightened by one in every objective, each under
    the symmetry group's orderings in turn."""
    name = os.path.splitext(os.path.basename(p.filename))[0]
    step = -1.0 if p.objsen is Sense.MIN else 1.0
    points = [p.initial_rhs()]
    for g in golden(name):
        points += [g, g + step]
    perms = sym_perms(p.objcnt)
    rhs = np.array([points[i % len(points)] for i in range(lanes)])
    perm = np.array([list(perms[(i // len(points) + i) % len(perms)]) for i in range(lanes)])
    return rhs, perm


def seeded_lanes(p, lanes, seed):
    """The initial rhs, then golden points moved by -1..1, each under a
    random ordering (tests/test_torch_cuda.py's lex lanes)."""
    rng = np.random.default_rng(seed)
    name = os.path.splitext(os.path.basename(p.filename))[0]
    gold, k = golden(name), p.objcnt
    rhs = np.array([
        p.initial_rhs() if b == 0 else gold[rng.integers(len(gold))] + rng.integers(-1, 2, size=k)
        for b in range(lanes)
    ])
    perm = np.array([rng.permutation(k) for _ in range(lanes)])
    return rhs, perm


@pytest.mark.parametrize(
    "name,lanes,max_nodes_stack",
    # G3KP10's lanes take hundreds of nodes each, about 18 ms a node alone
    [("G2AP05", 32, 160), ("G3AP05", 32, 160), ("G3KP10", 6, 160), ("G3KP10", 32, 4)],
    ids=["G2AP05", "G3AP05", "G3KP10", "G3KP10-stack4"],
)
def test_each_lane_alone_gives_the_batch(name, lanes, max_nodes_stack):
    """The plain loop called on one lane at a time gives the batch call's
    status, results, IPs and per-lane nodes and LP steps on every lane."""
    p = read_problem(f"{EX}/{name}.lp")
    rhs, perm = lex_lanes(p, lanes)
    kern = lex_torch.make_lex_kernel(p, max_nodes_stack=max_nodes_stack, device="cpu")
    batch = [t.clone() for t in kern(rhs, perm)] + [kern.lane_nodes, kern.lane_iters]
    assert (batch[3] > 0).all() and (batch[4] >= batch[3]).all()
    for b in range(lanes):
        one = lex_torch.make_lex_kernel(p, max_nodes_stack=max_nodes_stack, device="cpu")
        got = list(one(rhs[b : b + 1], perm[b : b + 1])) + [one.lane_nodes, one.lane_iters]
        for g, w in zip(got, batch):
            assert torch.equal(g[0], w[b]), b
    if max_nodes_stack == 4:
        assert (batch[0] == lex_torch.LEX_RESOURCE).any()


@pytest.mark.parametrize("name,lanes", [("G2AP05", 24), ("G3AP05", 24), ("G3KP10", 8)])
def test_seeded_lanes_match_lex_jax(name, lanes):
    """Seeded lanes (random orderings, golden points moved by -1..1) through
    the plain loop and ``lex_jax``: status, results and each lane's IPs
    equal."""
    p = read_problem(f"{EX}/{name}.lp")
    rhs, perm = seeded_lanes(p, lanes, seed=3)
    ref = lex_jax.make_lex_kernel(ref_read_problem(f"{EX}/{name}.lp"))
    want = [np.asarray(a) for a in ref(jnp.asarray(rhs), jnp.asarray(perm.astype(np.int32)))]
    kern = lex_torch.make_lex_kernel(p, device="cpu")
    got = [t.numpy() for t in kern(rhs, perm)]
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert (got[2] > 0).all() and len(set(got[0].tolist())) > 1
    assert kern.nodes == int(kern.lane_nodes.sum()) and kern.iters == int(kern.lane_iters.sum())
    assert kern.path_nodes == int(kern.lane_nodes.max())
    assert kern.path_iters == int(kern.lane_iters.max())
    assert kern.launches == 0 and not kern.plan_launches


#: (m, n) of the shapes K6's plan is held at: rows with the objective rows,
#: structural columns
SHAPES = {
    "G3KP10": (4, 10), "G2AP05": (12, 25), "G3AP05": (13, 25), "3AP10": (23, 100),
    "2AP20": (42, 400), "2AP40": (82, 1600), "2AP60": (122, 3600),
    # the card tests' generated knapsacks (``utils.generate.kp_lp``, 3, 9
    # and 13 capacity rows): the regs builds of 8 and 16 rows a column
    "KP6x12": (6, 12), "KP12x8": (12, 8), "KP16x10": (16, 10),
}
#: the shapes whose LPs fit a warp's registers, one column a thread
REGS = ("G3KP10", "KP6x12", "KP12x8", "KP16x10")
#: the shapes whose LPs fit a block's registers, one column a thread: at
#: most 32 rows, 33 to 128 columns
REGS_BLOCK = ("G2AP05", "G3AP05", "3AP10")
#: an H100's opt-in shared bytes a block (232,448), and clusters it holds
CAP = 232448
HELD = {1: 132, 2: 66, 4: 33, 8: 16}


def seg(nbytes):
    return -(-nbytes // 16) * 16


@pytest.mark.parametrize("name", SHAPES)
def test_lex_plan_counts_its_bytes_on_top_of_k5s(name):
    """Every K6 plan but regs is a K5 plan with K6's bytes added: per lane
    the node's rows c, lo, hi and x (in shared memory but for the global
    shape), the warps' winners (not in the packed shape) and the cluster's
    (split shapes); K6 fits no plan K5 does not.  The regs shape is K6's
    alone, a warp a lane at P = 1, 2, 4 and 8, with no shared byte, where
    the LP fits a warp's registers; so is regs_block, a block of one warp a
    window of 32 columns a lane, where the LP fits a block's registers."""
    m, n = SHAPES[name]
    nc = n + m
    k5 = {(q.shape, q.C, q.P): q for q in cuda_dense.plans_that_fit(m, nc, F64, CAP)}
    k6 = cuda_lex.lex_plans_that_fit(m, n, CAP)
    regs = [q for q in k6 if q.shape == "regs"]
    block = [q for q in k6 if q.shape == "regs_block"]
    k6 = [q for q in k6 if q.shape not in ("regs", "regs_block")]
    assert k6 and all((q.shape, q.C, q.P) in k5 for q in k6)
    assert not {"regs", "regs_block"} & {q.shape for q in k5.values()}
    assert [(q.P, q.threads, q.C) for q in regs] == (
        [(P, 32 * P, 1) for P in (1, 2, 4, 8)] if name in REGS else []
    )
    for q in regs:
        assert q.smem_bytes == cuda_lex.lex_bnb_smem_bytes("regs", m, n, 1, q.P) == 0
        assert q.code == 4 and q.row_values == q.scratch_values == 0
        assert q.layout == f"{q.P} x T in registers"
    assert [(q.P, q.threads, q.C) for q in block] == (
        [(1, 32 * -(-nc // 32), 1)] if name in REGS_BLOCK else []
    )
    for q in block:
        assert q.smem_bytes == cuda_lex.lex_bnb_smem_bytes("regs_block", m, n, 1, 1) > 0
        assert q.code == 5 and q.row_values == q.scratch_values == 0
        assert q.layout == f"T in registers, {q.threads // 32} warps"
    for q in k6:
        extra = 0 if q.shape == "global" else 3 * seg(8 * nc) + seg(8 * n)
        if q.shape != "packed":
            extra += seg(2 * 8 * 8) + seg(8 * 4)
        if q.shape in ("cluster", "global"):
            extra += seg(2 * q.C * 8) + seg(q.C * 4)
        lanes = q.P if q.shape == "packed" else 1
        assert q.smem_bytes == k5[q.shape, q.C, q.P].smem_bytes + lanes * extra
        assert q.smem_bytes == cuda_lex.lex_bnb_smem_bytes(q.shape, m, n, q.C, q.P)
        assert q.smem_bytes <= CAP - 1024
        assert q.row_values == (q.C * (3 * nc + n) if q.shape == "global" else 0)


@pytest.mark.parametrize(
    "name,lanes,want",
    [
        # an LP of at most 16 rows and 32 columns takes K6's own regs
        # shape, where K5 packs it; at 37, 38 and 123 columns, more than a
        # warp's threads, and at most 32 rows K6's own regs_block, a block
        # of 2 or 4 warps, where K5 packs it too
        ("G3KP10", 2, ("regs", 1, 4)), ("G3KP10", 32, ("regs", 1, 4)),
        ("KP6x12", 32, ("regs", 1, 4)), ("KP12x8", 32, ("regs", 1, 4)),
        ("KP16x10", 32, ("regs", 1, 4)),
        ("G2AP05", 32, ("regs_block", 1, 1)), ("G3AP05", 32, ("regs_block", 1, 1)),
        ("3AP10", 2, ("regs_block", 1, 1)), ("3AP10", 32, ("regs_block", 1, 1)),
        ("2AP20", 32, ("cluster", 4, 1)), ("2AP20", 128, ("block", 1, 1)),
        # 2AP40's float64 slice on a cluster of 8 fits K5 (181,792 bytes) but
        # not with K6's rows: K6 takes global, the C of the fewest rounds
        ("2AP40", 32, ("global", 4, 1)), ("2AP60", 32, ("global", 4, 1)),
    ],
)
def test_lex_plan_takes_k5s_rule(name, lanes, want):
    """K6's plan is regs where the LP has at most 16 rows and 32 columns,
    regs_block where it has at most 32 rows and 33 to 128 columns, else
    K5's rule over the plans that fit K6: a warp a lane where K5 packs,
    a shared-memory plan where one fits, else global.  K5 never takes
    regs or regs_block."""
    m, n = SHAPES[name]
    plan = cuda_lex.lex_plan_for(m, n, lanes, CAP, 132, HELD)
    assert isinstance(plan, cuda_lex.LexPlan) and plan.dsize == 8
    assert (plan.shape, plan.C, plan.P) == want
    k5 = cuda_dense.dense_loop_plan(m, n + m, F64, lanes, CAP, 132, HELD)
    if name == "2AP40":
        assert (k5.shape, k5.C) == ("cluster", 8)
    elif want[0] in ("regs", "regs_block"):
        assert (k5.shape, k5.C, k5.P) == ("packed", 1, 4)
    else:
        assert (k5.shape, k5.C, k5.P) == want
    if want[0] in ("regs", "regs_block"):
        # no shared byte, or a few KB within any card's default 48 KB a
        # block: the card's opt-in limit does not enter the rule
        assert cuda_lex.lex_plan_for(m, n, lanes, 1024, 132, HELD) == plan
    else:
        with pytest.raises(ValueError):  # a plan no cluster of 8 holds
            cuda_lex.lex_plan_for(m, n, lanes, 1024, 132, HELD)


@pytest.mark.parametrize(
    "m,n,takes",
    [
        (1, 0, True), (4, 10, True), (16, 16, True), (8, 24, True), (6, 20, True),
        # a 33rd column, a 17th row, no row
        (16, 17, False), (4, 29, False), (13, 25, False), (4, 61, False),
        (17, 10, False), (17, 0, False), (0, 10, False),
    ],
)
def test_lex_plan_refuses_regs_past_the_register_budget(m, n, takes, monkeypatch):
    """The regs shape takes at most 16 rows (a thread's column of
    registers) and 32 columns (one a thread); past those, K6's plan is
    K5's rule and ``regs_plan`` raises, at every P; P past 8 raises.  The
    rule a card applies (``cuda_dense.plan_on``, given an H100's limits)
    is ``lex_plan_for``'s."""
    assert cuda_lex.regs_takes(m, n) is takes
    if m == 0:
        return
    plan = cuda_lex.lex_plan_for(m, n, 32, CAP, 132, HELD)
    assert (plan.shape == "regs") is takes
    if takes:
        assert plan == cuda_lex.regs_plan(m, n)
        assert plan in cuda_lex.lex_plans_that_fit(m, n, CAP)
        with pytest.raises(ValueError):
            cuda_lex.regs_plan(m, n, 16)
    else:  # past the regs shape: regs_block where it takes the LP, else K5's rule
        assert plan == (cuda_lex.regs_block_plan(m, n) if cuda_lex.regs_block_takes(m, n)
                        else cuda_dense.dense_loop_plan(m, n + m, F64, 32, CAP, 132, HELD,
                                                        cuda_lex.LexPlan))
        for P in (1, 4, 8):
            with pytest.raises(ValueError):
                cuda_lex.regs_plan(m, n, P)
    monkeypatch.setattr(cuda_dense, "device_limits", lambda device: (CAP, 132))
    cuda_dense.plan_on.cache_clear()
    try:
        on_card = cuda_dense.plan_on(0, m, n + m, F64, 32, cuda_lex.LexPlan)
    finally:
        cuda_dense.plan_on.cache_clear()
    assert on_card == cuda_lex.lex_plan_for(m, n, 32, CAP, 132, {})


@pytest.mark.parametrize(
    "m,n,takes",
    [
        # 32 rows at 33 and at 128 columns; one row at 33; 24 rows at 128
        (32, 1, True), (32, 96, True), (1, 32, True), (24, 104, True), (13, 25, True),
        (23, 100, True),
        # a 33rd row, a 129th column, 32 columns (the regs shape's, or K5's
        # past 16 rows), no row
        (33, 0, False), (33, 95, False), (32, 97, False), (1, 128, False), (1, 31, False),
        (17, 15, False), (0, 40, False),
    ],
)
def test_lex_plan_takes_regs_block_within_a_blocks_registers(m, n, takes, monkeypatch):
    """The regs_block shape takes at most 32 rows (a row a warp lane) and
    33 to 128 columns (one a thread of up to four warps, a window of 32
    columns a warp): there K6's plan is ``regs_block_plan``, a block of
    ``windows(n + m)`` warps, one lane a block, and is among the plans that
    fit, and the rule a card applies (``cuda_dense.plan_on``, given an
    H100's limits) gives it too; past those it raises and the plan is the
    regs shape's or K5's rule."""
    assert cuda_lex.regs_block_takes(m, n) is takes
    if m == 0:
        return
    plan = cuda_lex.lex_plan_for(m, n, 32, CAP, 132, HELD)
    assert (plan.shape == "regs_block") is takes
    if takes:
        assert not cuda_lex.regs_takes(m, n)
        assert plan == cuda_lex.regs_block_plan(m, n)
        assert (plan.C, plan.P, plan.threads) == (1, 1, 32 * cuda_dense.windows(n + m))
        assert plan.threads <= 128 and (plan.threads - 32) < n + m <= plan.threads
        assert plan in cuda_lex.lex_plans_that_fit(m, n, CAP)
    else:
        with pytest.raises(ValueError):
            cuda_lex.regs_block_plan(m, n)
        assert "regs_block" not in {q.shape for q in cuda_lex.lex_plans_that_fit(m, n, CAP)}
        return
    monkeypatch.setattr(cuda_dense, "device_limits", lambda device: (CAP, 132))
    cuda_dense.plan_on.cache_clear()
    try:
        on_card = cuda_dense.plan_on(0, m, n + m, F64, 32, cuda_lex.LexPlan)
    finally:
        cuda_dense.plan_on.cache_clear()
    assert on_card == cuda_lex.lex_plan_for(m, n, 32, CAP, 132, {})


@pytest.mark.parametrize(
    "m,n,want",
    # 3AP10: four warps of 24 rows (a step's buffers 2 x 4 x (8 + 24)
    # values and 2 x 4 x 3 int32, the start's 4 x 24 values, the finish's
    # 4 x 3 values and 4 int32, the warps' 4 x (5 x 24 + 32) values);
    # G2AP05 and G3AP05: two warps of 24 rows; 32 rows and 128 columns:
    # four warps of 32
    [(23, 100, 2048 + 96 + 768 + 96 + 16 + 4864), (12, 25, 1024 + 48 + 384 + 48 + 16 + 2432),
     (13, 25, 1024 + 48 + 384 + 48 + 16 + 2432), (32, 96, 2560 + 96 + 1024 + 96 + 16 + 6144),
     (25, 20, 1280 + 48 + 512 + 48 + 16 + 3072)],
    ids=["3AP10", "G2AP05", "G3AP05", "rows32-cols128", "rows25-cols45"],
)
def test_lex_regs_block_counts_only_its_windows_bytes(m, n, want):
    """The regs_block shape's shared bytes are its windows', winners' and
    warps' copies alone (no tableau): each warp's winner with its tableau
    column in the step's two buffers, the start's windows of the basic
    values, the finish's windows of the objective and most fractional
    columns, and each warp's copies of the rows' five terms and of its 32
    columns' objective terms, each array 16-byte aligned, for the build's
    24 or 32 rows of registers."""
    plan = cuda_lex.regs_block_plan(m, n)
    assert plan.smem_bytes == cuda_lex.lex_bnb_smem_bytes("regs_block", m, n, 1, 1) == want
    assert cuda_lex.regs_block_rows(m) == (24 if m <= 24 else 32)


def test_backend_reports_the_lanes_counts():
    """A CPU front on the lex backend: backend_stats carries the kernel's
    nodes, LP steps and critical path, no K6 launch, and the plain loop's
    lockstep steps."""
    p = read_problem(f"{EX}/G2AP05.lp")
    be = lex_torch.TorchLexBackend(p, device="cpu")
    front = solve_front(p, n_workers=2, backend=be, device="cpu", dp="off")
    assert np.array_equal(front.points, golden("G2AP05"))
    st = front.backend_stats
    assert st["kernel_launches"] == 0 and st["k6_plans"] == []
    assert st["nodes"] == be.nodes > 0 and st["iters"] == be.iters > st["nodes"]
    assert st["nodes"] >= st["path_nodes"] >= st["device_batches"]
    assert st["path_iters"] == be.path_iters <= st["lp_steps"] == be.lp_steps
    assert st["host_syncs"] == be.host_syncs > st["bnb_steps"] == be.bnb_steps > 0


def test_kernel_and_wrapper_refuse_bad_inputs():
    """A perm outside the objectives, or a batch of the wrong width, raises
    before anything runs; K6's wrapper takes CUDA tensors only."""
    p = read_problem(f"{EX}/G3AP05.lp")
    kern = lex_torch.make_lex_kernel(p, device="cpu")
    rhs = np.tile(p.initial_rhs(), (2, 1))
    with pytest.raises(ValueError):
        kern(rhs, np.array([[0, 1, 3], [0, 1, 2]]))
    with pytest.raises(ValueError):
        kern(rhs[:, :2], np.array([[0, 1], [1, 0]]))
    assert kern.bnb_steps == 0
    perm = torch.tensor([[0, 1, 2], [2, 1, 0]])
    with pytest.raises(ValueError):
        cuda_lex.launch_lex_bnb(
            kern.W, torch.as_tensor(rhs), perm, kern.C, kern.lb, kern.ub, kern.row_lb,
            kern.row_ub, kern.is_int, kern.obj_integral, True, 160, 20000, 2000,
            1e-9, 1e-9, 1e-9, 1e-12, 60,
        )
    assert kern.launches == 0


@pytest.mark.parametrize("perm", [[[0, 1, 2], [0, 1, 3]], [[0, 1, 2], [-1, 1, 2]]],
                         ids=["past-k", "negative"])
def test_a_bad_perm_raises_before_the_distributed_round(perm):
    """A perm naming an objective outside [0, k) raises in the lex kernel
    and in the distributed round before any lane runs (on the card, a perm
    already there is K6's to refuse lane by lane); the plain loop keeps its
    lockstep counters, which a card's kernel does not have."""
    p = read_problem(f"{EX}/G3AP05.lp")
    rhs = np.tile(p.initial_rhs(), (2, 1))
    with pytest.raises(ValueError, match="outside"):
        lex_torch.check_perm(np.array(perm), p.objcnt)
    lex_torch.check_perm(np.array([[0, 1, 2], [2, 1, 0]]), p.objcnt)
    lex_torch.check_perm(torch.empty(0, 3, dtype=torch.int64), p.objcnt)
    step, B = mesh.make_distributed_round(p, mesh.make_mesh(2, devices=[torch.device("cpu")] * 2),
                                          batch_per_device=1)
    assert B == 2
    with pytest.raises(ValueError, match="outside"):
        step(rhs, np.array(perm))
    kern = lex_torch.make_lex_kernel(p, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        kern(rhs, torch.tensor(perm))
    assert kern.bnb_steps == kern.lp_steps == kern.host_syncs == 0
    assert kern.lane_pivots is None and kern.lp is not None
    assert kern.W.shape == (p.m_total, p.n + p.m_total) and kern.W.dtype == F64

"""K3 in the port: the plain PyTorch fragment walk
(``bb_torch.fragment_batch_ref``) against the Pallas kernel
``make_pallas_bb_batch`` in interpret mode, the port's copy of the host
audit (``bb_audit``), and K3's wrapper on the CPU (the CUDA kernel itself:
tests/test_torch_cuda.py).

Inputs are made with numpy from fixed seeds and handed to both sides.
Tolerances: per lane, the node count, every record's status and action, and
every branch record's column, floor and direction are equal (on a record
that does not branch the column and floor are the arg-max of f32 noise,
which the replay never reads); logged f32 objectives agree
to 1e-3 relative (two pivot paths whose sums run in another order, the
reference's own f32 tolerance) and ``best`` to 1e-4.  A lane whose two walks
part at an f32 near-tie (two columns equally fractional, or a branched
value at fl + 0.5) is named below with its seed, shown to part at such a
tie (``assert_near_tie``), and held instead to the exactness of its own
walk (``check_exactness``, after
tests/test_pallas_bb.py:82-125): every logged LP claim matches the exact
LP, the incumbent is feasible, and incumbent plus open nodes recover the
exact optimum.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moip_aira_tpu.solver.pallas_bb import make_pallas_bb_batch
from moip_aira_tpu_torch.convert import lp_tensors
from moip_aira_tpu_torch.io import read_problem
from moip_aira_tpu_torch.sense import INF, Sense
from moip_aira_tpu_torch.solver import bb_audit
from moip_aira_tpu_torch.solver import bb_torch as bt
from moip_aira_tpu_torch.solver.bnb_np import check_candidate, solve_mip
from moip_aira_tpu_torch.solver.cuda_bb import make_cuda_bb_batch
from moip_aira_tpu_torch.solver.cuda_lp import LAUNCHES
from moip_aira_tpu_torch.solver.simplex_np import SimplexWorkspace, solve_lp
from moip_aira_tpu_torch.solver.status import SolveStatus

EX = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
CPU = torch.device("cpu")
B = 8
SCAL = [bt.F_STATUS, bt.F_J, bt.F_FL, bt.F_DIR, bt.F_ACTION]
#: a few f32 rounding steps at 1: how close two fractionalities, or a value
#: and fl + 0.5, must lie to count as a tie
TIE = 4 * float(np.finfo(np.float32).eps)

#: (case, seed) -> lanes whose plain and Pallas walks part at an f32
#: near-tie; they are held to check_exactness instead, and
#: assert_near_tie shows the tie where they part: a basic value at 0.5 (the
#: branching direction) or two columns equally fractional (the branching
#: column, which the lowest basis row wins): 11 lanes of 64.
NEAR_TIES = {
    ("knapsack", 0): [0, 1, 2, 7],
    ("knapsack", 1): [4],
    ("knapsack", 4): [0],
    ("knapsack", 5): [0, 5],
    ("G2AP05", 4): [1, 4],
    ("G3KP10", 4): [1],
}


def knapsack_lanes(seed, n=12, n_rows=2):
    """B lanes over one knapsack system (make_knapsack of
    tests/test_pallas_bb.py with per-lane values and capacities): min -v.x
    s.t. A x <= cap, x binary.  Half the lanes carry no incumbent (+inf),
    the other half a greedy feasible value."""
    rng = np.random.default_rng(seed)
    A = rng.integers(2, 20, (n_rows, n)).astype(np.float64)
    m = n_rows
    c = np.zeros((B, n + m))
    lo = np.zeros((B, n + m))
    hi = np.zeros((B, n + m))
    par = np.zeros((B, 4), np.float32)
    for b in range(B):
        v = rng.integers(3, 30, n).astype(np.float64)
        cap = (A.sum(axis=1) * rng.uniform(0.35, 0.55)).round()
        c[b, :n] = -v
        lo[b, n:] = -np.inf
        hi[b, :n] = 1.0
        hi[b, n:] = cap
        x = np.zeros(n)
        for j in np.argsort(-v / A.sum(axis=0)):
            if np.all(A @ x + A[:, j] <= cap):
                x[j] = 1.0
        par[b] = [np.inf if b % 2 == 0 else -(v @ x), 1.0, 0.0, 1.0]
    W = np.hstack([A, -np.eye(m)])
    return A, W, c, lo, hi, par


def stage_root_lanes(name, seed):
    """B stage roots of a bundled instance as the fragment wave builds them:
    one stage objective per lane, an objective-bound box cut inside the
    golden front's range on most lanes, logical bounds row-scaled; half the
    lanes carry no incumbent."""
    rng = np.random.default_rng(seed)
    p = read_problem(os.path.join(EX, name + ".lp"))
    t = lp_tensors(p, CPU)
    n, m, k = p.n, p.m_total, p.objcnt
    front = np.array(
        [
            [int(v) for v in line.split()]
            for line in open(os.path.join(EX, name + ".out"))
            if line.split() and all(v.lstrip("-").isdigit() for v in line.split())
        ]
    )
    is_min = p.objsen is Sense.MIN
    c = np.zeros((B, n + m))
    lo = np.zeros((B, n + m))
    hi = np.zeros((B, n + m))
    for b in range(B):
        j = int(rng.integers(k))
        c[b, :n] = (1.0 if is_min else -1.0) * p.C[j]
        srhs = np.full(k, INF if is_min else -INF)
        for jj in range(k):
            if b > 0 and rng.random() < 0.6:
                srhs[jj] = float(rng.integers(front[:, jj].min(), front[:, jj].max() + 1))
        olo, ohi = (np.full(k, -INF), srhs) if is_min else (srhs, np.full(k, INF))
        lo[b] = np.concatenate([p.lb, p.row_lb, olo])
        hi[b] = np.concatenate([p.ub, p.row_ub, ohi])
    lo[:, n:] *= t.row_scale
    hi[:, n:] *= t.row_scale
    par = np.zeros((B, 4), np.float32)
    par[:, 0] = np.inf
    par[1::2, 0] = 1e4
    par[:, 1] = 1.0
    par[:, 3] = 1.0
    return p, t, t.W_dev.numpy(), c, lo, hi, par


def run_pallas(W, int_mask, c, lo, hi, par, F, D, wb=None, wa=None):
    """The Pallas kernel's outputs, with its at-upper flags unpacked under
    ``lg_atup_u``."""
    with jax.enable_x64(False):
        fn, meta = make_pallas_bb_batch(
            np.asarray(W, np.float32), np.asarray(int_mask, np.float32), B,
            F=F, D=D, interpret=True, compact=False,
        )
        args = [jnp.asarray(a, jnp.float32) for a in (c, lo, hi, par)]
        if wb is not None:
            args += [jnp.asarray(wb, jnp.int32), jnp.asarray(wa, jnp.int32)]
        out = {k: np.asarray(v) for k, v in fn(*args).items()}
        out["lg_atup_u"] = meta["unpack_atup"](out["lg_atup"])
        return out


def run_plain(W, int_mask, c, lo, hi, par, F, D, wb=None, wa=None, **kw):
    m, nc = W.shape
    if wb is None:
        wb = np.full((B, m), -1, np.int32)
        wa = np.zeros((B, nc), np.int32)
    return bt.fragment_batch_ref(
        torch.as_tensor(W, dtype=torch.float32), int_mask,
        *(torch.as_tensor(a, dtype=torch.float32) for a in (c, lo, hi, par)),
        torch.as_tensor(wb, dtype=torch.int32), torch.as_tensor(wa, dtype=torch.int32),
        F=F, D=D, **kw,
    )


def records_part(a, o):
    """Whether two records differ: status or action, a branch record's
    column, floor or direction, or the objective beyond 1e-3 relative.  (On
    a record that does not branch, the column and floor are the arg-max of
    f32 noise, which the replay never reads.)"""
    return bool(
        a[bt.F_STATUS] != o[bt.F_STATUS]
        or a[bt.F_ACTION] != o[bt.F_ACTION]
        or (a[bt.F_ACTION] == bt.ACT_BRANCH and not np.array_equal(a[SCAL], o[SCAL]))
        or abs(a[bt.F_OBJ] - o[bt.F_OBJ]) > 1e-3 * max(1.0, abs(a[bt.F_OBJ]))
    )


def scal_pair(ref, out, b):
    """Lane b's records, Pallas and plain, as f64 rows."""
    return (
        ref["lg_scal"][b, :, :8].astype(np.float64),
        out.lg_scal[b].numpy().astype(np.float64),
    )


def parted_lanes(ref, out):
    """Lanes whose walks differ from the Pallas kernel's: the node count,
    any record (``records_part``), or ``best`` beyond 1e-4."""
    bad = []
    for b in range(B):
        nl = int(ref["nlog"][b])
        s_ref, s_out = scal_pair(ref, out, b)
        best_ref, best_out = float(ref["best"][b]), float(out.best[b])
        same = (
            int(out.nlog[b]) == nl
            and not any(records_part(s_ref[t], s_out[t]) for t in range(nl))
            and (
                best_out == best_ref
                or abs(best_out - best_ref) <= 1e-4 * max(1.0, abs(best_ref))
            )
        )
        if not same:
            bad.append(b)
    return bad


def vertex(W, lo, hi, basis, atup):
    """The basic solution of a logged basis and its at-upper flags in the
    box (lo, hi), in f64: nonbasic columns where the kernels' restart puts
    them, basic ones solved from W x = 0."""
    W = np.asarray(W, np.float64)
    basis = np.asarray(basis).astype(np.int64)
    fin_lo, fin_hi = np.isfinite(lo), np.isfinite(hi)
    x = np.where(fin_lo, lo, np.where(fin_hi, hi, 0.0))
    x = np.where((np.asarray(atup) > 0) & fin_hi, hi, x)
    x[basis] = 0.0
    x[basis] = np.linalg.solve(W[:, basis], -W @ x)
    return x


def assert_near_tie(ref, out, W, lo, hi, int_mask, b):
    """Lane b's two walks part at a tie, not at a rule.  At the first record
    where they differ both sides branched from the same vertex (each side's
    logged basis and at-upper flags solved in f64 in the replayed box), and
    each side's column is a most fractional one (within TIE) with the rule's
    floor.  Then either the two columns are equally fractional within TIE
    (each side's f32 rounding, or the order of its basis rows, picked one),
    or the one column lies within TIE of fl + 0.5 and only the direction
    differs."""
    m, nc = W.shape
    n = nc - m
    s_ref, s_out = scal_pair(ref, out, b)
    nl = min(int(ref["nlog"][b]), int(out.nlog[b]))
    t = next(t for t in range(nl) if records_part(s_ref[t], s_out[t]))
    rep = bb_audit.replay_lane(lo[b, :n], hi[b, :n], out.lg_scal[b].numpy(), t + 1)
    box_lo = np.concatenate([rep.node_lo[t], lo[b, n:]])
    box_hi = np.concatenate([rep.node_hi[t], hi[b, n:]])
    x_ref = vertex(W, box_lo, box_hi, ref["lg_basis"][b, t, :m], ref["lg_atup_u"][b, t])
    atup_out = bt.unpack_atup_np(out.lg_atup.numpy(), nc)[b, t]
    x = vertex(W, box_lo, box_hi, out.lg_basis[b, t].numpy(), atup_out)
    assert np.abs(x_ref - x).max() <= 1e-9, (b, t)
    intm = np.zeros(nc)
    intm[:n] = np.asarray(int_mask, dtype=np.float64)
    fr = np.abs(x - np.round(x)) * intm
    for rec in (s_ref[t], s_out[t]):
        assert rec[bt.F_STATUS] == 0 and rec[bt.F_ACTION] == bt.ACT_BRANCH, (b, t)
        j = int(rec[bt.F_J])
        assert fr[j] >= fr.max() - TIE, (b, t, j)
        assert rec[bt.F_FL] == np.floor(x[j] + bt.INT_TOL), (b, t, j)
    j_ref, j = int(s_ref[t, bt.F_J]), int(s_out[t, bt.F_J])
    if j_ref != j:
        assert abs(fr[j_ref] - fr[j]) <= TIE, (b, t, j_ref, j)
    else:
        assert s_ref[t, bt.F_DIR] != s_out[t, bt.F_DIR], (b, t)
        assert abs(x[j] - s_out[t, bt.F_FL] - 0.5) <= TIE, (b, t, j, x[j])


def check_exactness(A_full, c, lo, hi, is_int, out, b, incumbent):
    """(a) every logged LP claim matches the exact LP of its replayed box,
    (b) the incumbent is feasible, (c) incumbent + open nodes + the records
    the audit sends to the host recover the exact optimum (lane b)."""
    m, n = A_full.shape
    ws = SimplexWorkspace(A_full)
    cs = c[b, :n]
    nlog = int(out.nlog[b])
    lgs = out.lg_scal[b].numpy()
    rep = bb_audit.replay_lane(lo[b, :n], hi[b, :n], lgs, nlog)
    for t in range(nlog):
        node_lo = np.concatenate([rep.node_lo[t], lo[b, n:]])
        node_hi = np.concatenate([rep.node_hi[t], hi[b, n:]])
        exact = solve_lp(ws, cs, node_lo, node_hi)
        claimed = int(lgs[t, bt.F_STATUS])
        if exact.status == SolveStatus.OPTIMAL and claimed == 0:
            assert float(lgs[t, bt.F_OBJ]) == pytest.approx(
                exact.obj, abs=1e-2 * max(1.0, abs(exact.obj))
            ), t
        elif exact.status == SolveStatus.INFEASIBLE:
            assert claimed in (1, 3), (t, claimed)
    best = float(out.best[b])
    if best < incumbent - 1e-9:
        v = check_candidate(ws, cs, lo[b], hi[b], np.round(out.bestx[b, :n].numpy()))
        assert v is not None and v == pytest.approx(best, abs=1e-4 * max(1.0, abs(v)))
        best = v
    ref = solve_mip(ws, cs, lo[b], hi[b], is_int, True)
    vals = [best]
    boxes = [
        (rep.node_lo[t], rep.node_hi[t])
        for t in range(nlog)
        if int(lgs[t, bt.F_ACTION]) == bt.ACT_ITERLIM
    ] + [(olo, ohi) for olo, ohi, _ in rep.open_nodes]
    for olo, ohi in boxes:
        rr = solve_mip(
            ws, cs, np.concatenate([olo, lo[b, n:]]),
            np.concatenate([ohi, hi[b, n:]]), is_int, True,
        )
        if rr.status == SolveStatus.OPTIMAL:
            vals.append(rr.obj)
    if ref.status == SolveStatus.OPTIMAL:
        assert min(vals) == pytest.approx(ref.obj, abs=1e-6)
    else:
        assert not np.isfinite(min(vals)) or min(vals) >= incumbent


@pytest.mark.parametrize("seed", range(6))
def test_plain_matches_pallas_on_knapsack_lanes(seed):
    A, W, c, lo, hi, par = knapsack_lanes(seed)
    F, D = 64, 32
    par[:, 2] = F
    n = A.shape[1]
    ref = run_pallas(W, np.ones(n), c, lo, hi, par, F, D)
    out = run_plain(W, np.ones(n), c, lo, hi, par, F, D)
    bad = parted_lanes(ref, out)
    assert bad == NEAR_TIES.get(("knapsack", seed), []), bad
    assert int(out.nlog.sum()) > B  # the lanes branch
    for b in bad:
        assert_near_tie(ref, out, W, lo, hi, np.ones(n), b)
        check_exactness(A, c, lo, hi, np.ones(n, bool), out, b, float(par[b, 0]))


@pytest.mark.parametrize("name", ["G2AP05", "G3KP10"])
def test_plain_matches_pallas_on_stage_roots(name):
    p, t, W, c, lo, hi, par = stage_root_lanes(name, seed=4)
    F, D = 16, 32
    par[:, 2] = F
    ref = run_pallas(W, p.is_int, c, lo, hi, par, F, D)
    out = run_plain(W, p.is_int, c, lo, hi, par, F, D)
    bad = parted_lanes(ref, out)
    assert bad == NEAR_TIES.get((name, 4), []), bad
    lo_u, hi_u = lo.copy(), hi.copy()  # the unscaled system check_exactness reads
    lo_u[:, p.n :] /= t.row_scale
    hi_u[:, p.n :] /= t.row_scale
    for b in bad:
        assert_near_tie(ref, out, W, lo, hi, p.is_int, b)
        check_exactness(t.A_full, c, lo_u, hi_u, p.is_int, out, b, float(par[b, 0]))


def test_replay_rebuilds_the_logged_boxes():
    """bb_audit.replay_lane rebuilds every box the plain walk logged: each
    record's claim is the exact LP of its replayed box, and on every lane
    incumbent plus open nodes recover the exact optimum (budget stops
    included: lanes 0 and 3 stop after 3 and 6 nodes)."""
    A, W, c, lo, hi, par = knapsack_lanes(2)
    F, D = 64, 32
    par[:, 2] = F
    par[0, 2], par[3, 2] = 3, 6
    n = A.shape[1]
    out = run_plain(W, np.ones(n), c, lo, hi, par, F, D)
    assert out.lstate[0] == bt.LS_BUDGET and out.nlog[0] == 3
    assert out.lstate[3] == bt.LS_BUDGET and out.nlog[3] == 6
    assert (out.lstate[[1, 2, 4, 5, 6, 7]] == bt.LS_EXHAUSTED).all()
    for b in range(B):
        check_exactness(A, c, lo, hi, np.ones(n, bool), out, b, float(par[b, 0]))


def test_tick_stop_leaves_the_pending_node_open():
    """A lane stopped by the tick budget keeps LS_TICKS; its replay leaves
    the node it was solving open, and the lane's final basis (fin_basis,
    fin_atup) is the one it stopped with."""
    A, W, c, lo, hi, par = knapsack_lanes(3)
    F, D = 64, 32
    par[:, 2] = F
    n = A.shape[1]
    out = run_plain(W, np.ones(n), c, lo, hi, par, F, D, max_ticks=30)
    assert (out.ticks <= 30).all() and (out.lstate == bt.LS_TICKS).any()
    for b in torch.nonzero(out.lstate == bt.LS_TICKS).flatten().tolist():
        rep = bb_audit.replay_lane(lo[b, :n], hi[b, :n], out.lg_scal[b].numpy(), int(out.nlog[b]))
        assert rep.pending and rep.open_nodes
        check_exactness(A, c, lo, hi, np.ones(n, bool), out, b, float(par[b, 0]))
    full = run_plain(W, np.ones(n), c, lo, hi, par, F, D)
    # the same walk, cut short: the stopped lanes logged a prefix of it
    for b in range(B):
        k = int(out.nlog[b])
        assert torch.equal(out.lg_scal[b, :k], full.lg_scal[b, :k])


def test_warm_root_matches_cold_and_a_singular_root_starts_cold():
    """A root warm from the exact optimal basis claims the cold root's LP in
    at most two pivots; a root basis that names one column m times is
    singular and the lane walks exactly the cold walk."""
    A, W, c, lo, hi, par = knapsack_lanes(7)
    m, nc = W.shape
    n = nc - m
    F, D = 16, 16
    par[:, 2] = F
    cold = run_plain(W, np.ones(n), c, lo, hi, par, F, D)
    ws = SimplexWorkspace(A)
    wb = np.full((B, m), -1, np.int32)
    wa = np.zeros((B, nc), np.int32)
    for b in range(0, B, 2):
        r0 = solve_lp(ws, c[b, :n], lo[b], hi[b])
        wb[b] = np.flatnonzero(r0.in_basis)
        wa[b] = r0.at_upper[:nc] > 0
    wb[1] = np.flatnonzero(W[0] == 0)[0]  # one column m times
    warm = run_plain(W, np.ones(n), c, lo, hi, par, F, D, wb=wb, wa=wa)
    for b in range(0, B, 2):
        assert warm.lg_scal[b, 0, bt.F_STATUS] == cold.lg_scal[b, 0, bt.F_STATUS] == 0
        assert float(warm.lg_scal[b, 0, bt.F_OBJ]) == pytest.approx(
            float(cold.lg_scal[b, 0, bt.F_OBJ]), abs=1e-3
        )
        assert warm.lg_scal[b, 0, bt.F_ITERS] <= 2 < cold.lg_scal[b, 0, bt.F_ITERS]
    for f in cold._fields:
        assert torch.equal(getattr(warm, f)[1], getattr(cold, f)[1]), f


def test_audit_records_classification():
    """The port's copy of audit_records: confirmed closures against
    host-resolution records (tests/test_pallas_bb.py:177-206)."""
    recs = np.zeros((5, 8), np.float32)
    recs[0, bt.F_ACTION] = bt.ACT_BRANCH
    recs[1, bt.F_ACTION] = bt.ACT_LEAF
    recs[2, bt.F_ACTION] = bt.ACT_PRUNE
    recs[3, bt.F_ACTION] = bt.ACT_INFEAS
    recs[4, bt.F_ACTION] = bt.ACT_ITERLIM
    dual_lb = np.array([-np.inf, -3.2, -4.9, np.inf, -np.inf])
    leaf_ok = np.array([False, True, False, False, False])
    box_empty = np.zeros(5, bool)
    res = bb_audit.audit_records(recs, dual_lb, leaf_ok, box_empty, final_best=-4.0, obj_int=True)
    assert res.host_recs == [4] and res.confirmed == 3
    leaf_ok[1] = False
    res2 = bb_audit.audit_records(recs, dual_lb, leaf_ok, box_empty, final_best=-4.0, obj_int=True)
    assert res2.host_recs == [1, 4]
    res3 = bb_audit.audit_records(recs, dual_lb, leaf_ok, box_empty, final_best=-3.0, obj_int=True)
    assert 2 in res3.host_recs


def test_replay_mirrors_a_known_walk():
    """White box: replayed boxes for a known branch/backtrack pattern
    (tests/test_pallas_bb.py:209-233, on the port's copy)."""
    root_lo, root_hi = np.zeros(4), np.ones(4) * 5
    recs = np.zeros((4, 8), np.float32)
    recs[0, [bt.F_ACTION, bt.F_J, bt.F_FL, bt.F_DIR]] = [bt.ACT_BRANCH, 1, 2, 1]
    recs[1, [bt.F_ACTION, bt.F_J, bt.F_FL, bt.F_DIR]] = [bt.ACT_BRANCH, 3, 0, 0]
    recs[2, bt.F_ACTION] = bt.ACT_LEAF
    recs[3, bt.F_ACTION] = bt.ACT_INFEAS
    rep = bb_audit.replay_lane(root_lo, root_hi, recs, 4)
    assert np.array_equal(rep.node_hi[1], [5, 2, 5, 5])
    assert np.array_equal(rep.node_lo[2], [0, 0, 0, 1])
    assert np.array_equal(rep.node_hi[3], [5, 2, 5, 0])
    assert len(rep.open_nodes) == 1
    olo, ohi, parent = rep.open_nodes[0]
    assert olo[1] == 3 and ohi[1] == 5 and parent == 0


def test_packed_at_upper_flags_round_trip():
    rng = np.random.default_rng(0)
    for nc in (1, 31, 32, 33, 442):
        flags = rng.random((3, 5, nc)) < 0.5
        words = bt.pack_atup(torch.as_tensor(flags))
        assert words.dtype == torch.int32 and words.shape == (3, 5, bt.packed_words(nc))
        back = bt.unpack_atup_np(words.numpy(), nc)
        assert back.flags["C_CONTIGUOUS"] and np.array_equal(back, flags)


def test_wrapper_runs_the_plain_version_on_the_cpu():
    """K3's wrapper on CPU tensors: the plain version's outputs, the records
    compacted at cumsum(nlog) - nlog (and cut at CAP), the inputs checked,
    and no launch counted."""
    A, W, c, lo, hi, par = knapsack_lanes(5)
    n = A.shape[1]
    F = 32
    par[:, 2] = F
    fn, meta = make_cuda_bb_batch(torch.as_tensor(W, dtype=torch.float32), np.ones(n), CPU, F=F, D=32)
    assert meta["F"] == F and meta["PW"] == 1 and meta["nc"] == W.shape[1]
    t = [torch.as_tensor(a, dtype=torch.float32).contiguous() for a in (c, lo, hi, par)]
    launches0 = LAUNCHES["bb_fragment"]
    out = fn(*t)
    ref = run_plain(W, np.ones(n), c, lo, hi, par, F, 32)
    for f in ref._fields:
        assert torch.equal(out[f], getattr(ref, f)), f
    nl = out["nlog"].clamp(max=F).tolist()
    rows = [out["lg_scal"][b, :k] for b, k in enumerate(nl)]
    assert torch.equal(out["lg_cscal"][: sum(nl)], torch.cat(rows))
    assert not out["lg_cscal"][sum(nl) :].any()
    assert torch.equal(
        out["lg_cbasis"][: sum(nl)], torch.cat([out["lg_basis"][b, :k] for b, k in enumerate(nl)])
    )
    fn.cap = 5  # fewer rows than records: the first five survive
    small = fn(*t)
    assert torch.equal(small["lg_cscal"], torch.cat(rows)[:5])
    assert fn.launches == 0 and LAUNCHES["bb_fragment"] == launches0
    with pytest.raises(TypeError):
        fn(t[0].double(), *t[1:])
    with pytest.raises(ValueError):
        fn(*t[:3], t[3][:, :3].contiguous())

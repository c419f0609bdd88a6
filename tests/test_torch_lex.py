"""The port's lex backend (``backend="jax"``: solver/lex_torch.py on the
dense simplex of solver/simplex_dense.py) on the CPU against the JAX
package's (solver/lex_jax.py on solver/simplex_jax.py), on the same
numpy-seeded inputs: LP status, objective (within 1e-9 relative) and x
(within 1e-8); lex status, results and IPs exactly; and the golden fronts
through solve_front in the reference's five configurations."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moip_aira_tpu.io import read_problem as ref_read_problem
from moip_aira_tpu.parallel.symgroup import sym_perms
from moip_aira_tpu.solver import lex_jax, simplex_jax
from moip_aira_tpu_torch.api import make_backend, solve_front
from moip_aira_tpu_torch.io import read_problem
from moip_aira_tpu_torch.sense import Sense
from moip_aira_tpu_torch.solver import lex_torch
from moip_aira_tpu_torch.solver.lex import LexRequest
from moip_aira_tpu_torch.solver.simplex_dense import make_lp_solver

EX = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
LANES = 32


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
    return np.array(rows)


def problems(name):
    return ref_read_problem(f"{EX}/{name}.lp"), read_problem(f"{EX}/{name}.lp")


def lp_boxes(p, lanes, seed):
    """A batch of bounded LPs of ``p``: one stage objective a lane, the
    objective rows bounded at a golden point moved by -1..1, a few
    variables fixed."""
    rng = np.random.default_rng(seed)
    name = os.path.splitext(os.path.basename(p.filename))[0]
    gold = golden(name).astype(np.float64)
    n, m, k = p.n, p.m_total, p.objcnt
    c = np.zeros((lanes, n + m))
    lo = np.zeros((lanes, n + m))
    hi = np.zeros((lanes, n + m))
    for b in range(lanes):
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
    return c, lo, hi


@pytest.mark.parametrize("name,lanes", [("G2AP05", 64), ("G3KP10", 64), ("2AP20", 16)])
def test_dense_simplex_matches_simplex_jax(name, lanes):
    _, p = problems(name)
    W = np.hstack([np.vstack([p.A, p.C]), -np.eye(p.m_total)])
    c, lo, hi = lp_boxes(p, lanes, seed=1)
    ref = jax.jit(jax.vmap(simplex_jax.make_lp_solver(jnp.asarray(W), 2000)))(
        jnp.asarray(c), jnp.asarray(lo), jnp.asarray(hi)
    )
    out = make_lp_solver(torch.as_tensor(W), 2000)(
        torch.as_tensor(c), torch.as_tensor(lo), torch.as_tensor(hi)
    )
    status = out.status.numpy()
    assert np.array_equal(status, np.asarray(ref.status))
    assert {0, 1} <= set(status.tolist())  # optimal and infeasible lanes
    ok = status == 0
    ref_obj = np.asarray(ref.obj)[ok]
    assert np.all(np.abs(out.obj.numpy()[ok] - ref_obj) <= 1e-9 * np.maximum(1.0, np.abs(ref_obj)))
    assert np.abs(out.x.numpy()[ok] - np.asarray(ref.x)[ok]).max() <= 1e-8


def lex_lanes(p, lanes=LANES):
    """The initial rhs, the golden points and the golden points tightened
    by one in every objective (infeasible: a golden point is
    nondominated), each under the symmetry group's orderings in turn."""
    name = os.path.splitext(os.path.basename(p.filename))[0]
    gold = golden(name).astype(np.float64)
    step = -1.0 if p.objsen is Sense.MIN else 1.0
    points = [p.initial_rhs()]
    for g in gold:
        points += [g, g + step]
    perms = sym_perms(p.objcnt)
    rhs = np.array([points[i % len(points)] for i in range(lanes)])
    perm = np.array([list(perms[(i // len(points) + i) % len(perms)]) for i in range(lanes)])
    return rhs, perm


_JAX_KERNELS = {}


def jax_kernel(name, max_nodes_stack=160):
    """One jitted reference kernel per problem and stack size, built once
    for the module."""
    key = (name, max_nodes_stack)
    if key not in _JAX_KERNELS:
        rp, _ = problems(name)
        _JAX_KERNELS[key] = lex_jax.make_lex_kernel(rp, max_nodes_stack=max_nodes_stack)
    return _JAX_KERNELS[key]


@pytest.mark.parametrize(
    "name,max_nodes_stack",
    [("G2AP05", 160), ("G3AP05", 160), ("G3KP10", 160), ("G3KP10", 4)],
    ids=["G2AP05", "G3AP05", "G3KP10", "G3KP10-stack4"],
)
def test_lex_kernel_matches_lex_jax(name, max_nodes_stack):
    _, p = problems(name)
    rhs, perm = lex_lanes(p)
    ref = [np.asarray(a) for a in jax_kernel(name, max_nodes_stack)(
        jnp.asarray(rhs), jnp.asarray(perm.astype(np.int32))
    )]
    kern = lex_torch.make_lex_kernel(p, max_nodes_stack=max_nodes_stack, device="cpu")
    got = [t.numpy() for t in kern(rhs, perm)]
    for a, b in zip(got, ref):
        assert np.array_equal(a, b)
    status = got[0]
    if max_nodes_stack == 4:
        # the tiny stack overflows on every lane that branches
        assert (status == lex_torch.LEX_RESOURCE).any()
    else:
        assert (status == lex_torch.LEX_OPTIMAL).any()
        assert (status == lex_torch.LEX_INFEASIBLE).any()
        assert not (status == lex_torch.LEX_RESOURCE).any()
    assert kern.bnb_steps > 0 and kern.lp_steps > kern.bnb_steps


def test_backend_matches_jax_backend_with_fallbacks():
    """Both backends on the same requests with a 2-node stack: the lanes
    that overflow it go to the exact host backend, counted alike."""
    rp, p = problems("G3AP05")
    rhs, perm = lex_lanes(p, 40)  # more than one batch of 32
    reqs = [LexRequest(rhs=r, perm=list(q)) for r, q in zip(rhs, perm)]
    ref_be = lex_jax.JaxLexBackend(rp, max_nodes_stack=2)
    be = lex_torch.TorchLexBackend(p, device="cpu", max_nodes_stack=2)
    ref = ref_be.lex_solve_batch(reqs)
    got = be.lex_solve_batch(reqs)
    for a, b in zip(got, ref):
        assert a.status == b.status and a.ip_solves == b.ip_solves
        assert (a.result is None) == (b.result is None)
        if a.result is not None:
            assert np.array_equal(a.result, b.result)
    assert be.fallback_count == ref_be.fallback_count > 0
    assert be.device_batches == ref_be.device_batches == 2
    assert be.lanes == 40
    assert be.host_syncs > be.bnb_steps > 0


#: the reference's five configurations (tests/test_bundled_examples.py:33-43)
#: and n_workers=2, whose IP counts the JAX package's jax backend gives
CONFIGS = {
    "t1": dict(n_workers=1),
    "t3": dict(n_workers=3),
    "t2-cluster": dict(n_workers=2, spread=False),
    "t2-split": dict(n_workers=2, split=True),
    "t3-split-normal": dict(n_workers=3, split=True, split_normal=True),
    "t2": dict(n_workers=2),
}
T2_IPS = {"G2AP05": 24, "G3AP05": 57, "G3KP10": 109}
#: the lex backend's CPU pivots take minutes at G3KP10 (a long serial
#: chain of tiny LPs per lane): those rows are slow tests
MATRIX = [
    pytest.param(name, cfg, id=f"{name}-{cfg}",
                 marks=[pytest.mark.slow] if name == "G3KP10" else [])
    for name in ("G2AP05", "G3AP05", "G3KP10")
    for cfg in CONFIGS
]


@pytest.mark.parametrize("name,cfg", MATRIX)
def test_lex_backend_golden_matrix(name, cfg):
    _, p = problems(name)
    front = solve_front(p, backend="jax", device="cpu", dp="off", **CONFIGS[cfg])
    assert np.array_equal(front.points, golden(name))
    stats = front.backend_stats
    assert stats["backend"] == "jax" and stats["device_batches"] > 0
    if cfg == "t2":
        assert front.ip_count == T2_IPS[name]


def test_auto_takes_the_lex_backend_on_the_cpu():
    """A problem no family detector claims goes to the lex backend on the
    CPU, as the reference's auto routes it (moip_aira_tpu/api.py:109-124)."""
    _, p = problems("G2AP05")
    assert make_backend(p, "auto", device="cpu").name == "apbb"
    p.C = p.C.copy()
    p.C[0, 0] += 0.5  # a fractional objective: no assignment family
    be = make_backend(p, "auto", device="cpu")
    assert isinstance(be, lex_torch.TorchLexBackend) and be.name == "jax"


def test_sweep_drives_the_lex_backend():
    _, p = problems("G2AP05")
    front = solve_front(p, n_workers=2, backend="jax", device="cpu", dp="off")
    assert front.rounds == 6 and front.ip_count == 24
    assert np.array_equal(front.points, golden("G2AP05"))

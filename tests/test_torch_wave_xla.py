"""The wave's XLA engine, ``WaveLexBackend(engine="xla")`` (solver/xla_lp.py on
the dense simplex of solver/simplex_dense.py), on the CPU against the JAX
package's ``engine="xla"`` (``simplex_jax.make_lp_solver`` vmapped and
jitted), on the same numpy-seeded inputs.

In float32 the port sums as XLA's CPU backend does (``xla_sum``,
``xla_dot``), so the solver's outputs equal the reference's bit for bit and
the wave's counts equal its counts.  In float64 the solver pivots as the
reference does (tests/test_torch_lex.py), but the port certifies every
lane in float64 where the reference's float64 mode prunes on the device's
values, and the certificate's duals drive reduced-cost fixing there: the
outcomes are equal, the waves and LPs are the port's own."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moip_aira_tpu.io import read_problem as ref_read_problem
from moip_aira_tpu.solver import simplex_jax
from moip_aira_tpu.solver.wave import WaveLexBackend as RefWave
from moip_aira_tpu_torch.api import backend_stats, solve_front
from moip_aira_tpu_torch.engine.scheduler import Scheduler
from moip_aira_tpu_torch.io import read_problem
from moip_aira_tpu_torch.native import make_solutions
from moip_aira_tpu_torch.parallel import mesh
from moip_aira_tpu_torch.parallel.cluster import build_cluster
from moip_aira_tpu_torch.problem import Problem
from moip_aira_tpu_torch.sense import Sense
from moip_aira_tpu_torch.solver.cuda_lp import LAUNCHES
from moip_aira_tpu_torch.solver.simplex_dense import xla_dot, xla_sum
from moip_aira_tpu_torch.solver.wave import WaveLexBackend
from moip_aira_tpu_torch.solver.xla_lp import F32_TOLERANCES, XlaLPBatch
from test_differential import brute_force_front, random_problem
from test_torch_lex import lp_boxes, problems
from test_torch_wave import GRIDS, outcomes

EX = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
CPU, CPU0 = torch.device("cpu"), torch.device("cpu", 0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
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


# -- (a) the solver in float32 ------------------------------------------------


@pytest.mark.parametrize(
    "name,lanes", [("G3KP10", 64), ("KP2D50", 64), ("G2AP05", 64), ("2AP20", 32)]
)
def test_f32_solver_matches_simplex_jax_bit_for_bit(name, lanes):
    """The batches of tests/test_torch_lex.py (seed 1) at the wave's float32
    tolerances: status, basis, iteration count, at-upper flags, x and the
    objective equal the reference's bit for bit on every lane (tolerance 0)."""
    _, p = problems(name)
    W = np.hstack([np.vstack([p.A, p.C]), -np.eye(p.m_total)]).astype(np.float32)
    c, lo, hi = (a.astype(np.float32) for a in lp_boxes(p, lanes, seed=1))
    ref = jax.jit(jax.vmap(simplex_jax.make_lp_solver(jnp.asarray(W), 2000, **F32_TOLERANCES)))(
        jnp.asarray(c), jnp.asarray(lo), jnp.asarray(hi)
    )
    out = XlaLPBatch(W, "cpu")(*(torch.from_numpy(a) for a in (c, lo, hi)))
    for key in ("status", "basis", "iters", "at_upper", "x", "obj"):
        assert np.array_equal(
            getattr(out, key).numpy(), np.asarray(getattr(ref, key)).astype(getattr(out, key).numpy().dtype)
        ), key
    assert {0, 1} <= set(out.status.tolist())


@pytest.mark.parametrize("L", [1, 4, 12, 32, 33, 42, 64, 442, 1682])
def test_xla_sums_follow_xla(L):
    """xla_sum and xla_dot against jnp.sum under jit, bit for bit, across
    the window edges: rows of mixed magnitudes, where the order shows."""
    rng = np.random.default_rng(L)
    x = (rng.standard_normal((8, L)) * rng.choice([1e-3, 1.0, 1e3], (8, L))).astype(np.float32)
    y = rng.standard_normal((8, L)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=1))(x))
    assert np.array_equal(xla_sum(torch.from_numpy(x), 1).numpy(), want)
    want = np.asarray(jax.jit(lambda a, b: jnp.sum(a * b, axis=1))(x, y))
    assert np.array_equal(xla_dot(torch.from_numpy(x), torch.from_numpy(y), 1).numpy(), want)


# -- (b) the wave against the reference's XLA engine --------------------------


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", ["G2AP05", "G3KP10"])
def test_wave_matches_the_reference_xla_engine(name, dtype):
    path = os.path.join(EX, f"{name}.lp")
    reqs = GRIDS[name]()
    port = WaveLexBackend(
        read_problem(path), device="cpu", batch_width=64, engine="xla", dtype=dtype
    )
    ref = RefWave(
        ref_read_problem(path), engine="xla", fragments=False, batch_width=64, dtype=dtype
    )
    assert port.warm_start is ref.warm_start is False
    assert outcomes(port, reqs) == outcomes(ref, reqs)
    if dtype == "float32":
        # the pivots are the reference's, so are the waves and LPs
        assert (port.device_waves, port.lp_count, port.verify_fallbacks) == (
            ref.device_waves, ref.lp_count, ref.verify_fallbacks
        )
    else:
        # every float64 claim certified: no lane went to the host
        assert port.verify_fallbacks == ref.verify_fallbacks == 0
    assert port.device_waves > 0 and port.lp_kernel.launches == 0


def test_warm_start_gathers_as_the_reference_does():
    """warm_start=True on the XLA engine: the warm bases are ignored, and
    the waves are gathered homogeneously, so the waves and LPs are the
    reference's with the same switch."""
    path = os.path.join(EX, "G2AP05.lp")
    reqs = GRIDS["G2AP05"]()
    port = WaveLexBackend(read_problem(path), device="cpu", batch_width=64,
                          engine="xla", warm_start=True)
    ref = RefWave(ref_read_problem(path), engine="xla", fragments=False,
                  batch_width=64, warm_start=True)
    assert port.warm_start and ref.warm_start
    assert outcomes(port, reqs) == outcomes(ref, reqs)
    assert (port.device_waves, port.lp_count) == (ref.device_waves, ref.lp_count)


def test_engine_choices_and_stats():
    p = read_problem(os.path.join(EX, "G2AP05.lp"))
    be = WaveLexBackend(p, device="cpu", engine="xla", dtype="float64")
    assert type(be.lp_kernel) is XlaLPBatch and be.lp_kernel.dtype == torch.float64
    assert be.lp_kernel.max_iters == 2000 and be.dtype == "float64"
    # the kernels always run float32, whatever dtype says
    assert WaveLexBackend(p, device="cpu", dtype="float64").dtype == "float32"
    assert WaveLexBackend(p, device="cpu").engine == "dense"  # auto keeps K1/K2
    with pytest.raises(ValueError, match="dtype"):
        WaveLexBackend(p, device="cpu", engine="xla", dtype="float16")
    launches0 = dict(LAUNCHES)
    front = solve_front(p, backend=be, device="cpu")
    assert np.array_equal(front.points, golden("G2AP05"))
    st = front.backend_stats
    assert st["kernel"] == "xla" and st["kernel_launches"] == 0 and LAUNCHES == launches0
    assert st["lp_steps"] == be.lp_kernel.steps > 0
    assert st["host_syncs"] == be.lp_kernel.syncs >= st["lp_steps"]
    assert "graphs" not in st  # the engine captures no CUDA graph
    assert backend_stats(be)["device_lanes"] == {"cpu": be.lp_count}


# -- (c) the fronts -----------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name,workers", [("G2AP05", 1), ("G3AP05", 2), ("G3KP10", 2)])
def test_front_matches_golden(name, workers, dtype):
    """G2AP05 through the bound sweep, G3AP05 and G3KP10 through the AIRA
    scheduler, all on the XLA engine."""
    p = read_problem(os.path.join(EX, f"{name}.lp"))
    be = WaveLexBackend(p, device="cpu", engine="xla", dtype=dtype)
    front = solve_front(p, n_workers=workers, backend=be, device="cpu", dp="off")
    assert np.array_equal(front.points, golden(name))
    assert be.device_waves > 0 and be.lp_kernel.steps > 0


# -- (d) the certificate guard ------------------------------------------------


def _poison(be):
    """Every certificate declared failed, its duals poisoned: reduced-cost
    fixing must never read them (tests/test_wave_cert_guard.py)."""
    real = be._verifier.certify

    def poisoned(c, lo, hi, status, basis, at_upper):
        cert = real(c, lo, hi, status, basis, at_upper)
        return cert._replace(
            ok=np.zeros_like(cert.ok),
            d=np.full_like(cert.d, 1e6),
            at_upper=np.zeros_like(cert.at_upper),
            in_basis=np.zeros_like(cert.in_basis),
        )

    be._verifier.certify = poisoned


def _run_front(p, be):
    sched = Scheduler(p, be)
    store = make_solutions(p.objcnt)
    infeas = make_solutions(p.objcnt)
    sched.run(build_cluster(1, p.objcnt, p.objsen, True), store, infeas)
    return sorted(map(tuple, store.sorted_unique_points()))


def port_problem(rp):
    """The JAX package's Problem as the port's."""
    fields = {f: getattr(rp, f) for f in Problem.__dataclass_fields__}
    fields["objsen"] = Sense[rp.objsen.name]
    return Problem(**fields)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("seed", range(8))
def test_random_front_exact_when_all_certificates_fail(seed, dtype):
    rp = random_problem(seed, 2)
    want = sorted(map(tuple, brute_force_front(rp)))
    be = WaveLexBackend(port_problem(rp), device="cpu", batch_width=32, engine="xla", dtype=dtype)
    _poison(be)
    assert _run_front(be.problem, be) == want, seed
    if be.device_waves:
        assert be.verify_fallbacks > 0


def test_g3ap05_front_exact_when_all_certificates_fail():
    p = read_problem(os.path.join(EX, "G3AP05.lp"))
    be = WaveLexBackend(p, device="cpu", batch_width=32, engine="xla")
    _poison(be)
    got = _run_front(p, be)
    assert be.verify_fallbacks > 0  # the host path really ran
    assert got == sorted(map(tuple, golden("G3AP05")))


# -- (e) the mesh ---------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def mesh_run(split):
    p = read_problem(os.path.join(EX, "G3AP05.lp"))
    devices = [CPU, CPU0] * 4 if split else [CPU] * 8
    be = WaveLexBackend(p, device="cpu", engine="xla", mesh=mesh.make_mesh(8, devices=devices))
    front = solve_front(p, n_workers=6, backend=be, device="cpu", mesh_devices=8, dp="off")
    return be, front


def test_mesh_of_two_device_keys_gives_the_one_key_counts():
    """G3AP05 on 8 domains over two CPU keys: one XLA wrapper a key, every
    wave's lanes split between them, and the one-key mesh's front, IPs,
    waves, LPs and fallbacks."""
    be1, one = mesh_run(False)
    be2, two = mesh_run(True)
    assert len(be1.lp_kernels) == 1 and len(be2.lp_kernels) == 2
    for front in (one, two):
        assert np.array_equal(front.points, golden("G3AP05"))
    assert (two.ip_count, two.domain_ips, two.pre_ips) == (one.ip_count, one.domain_ips, one.pre_ips)
    assert (be2.device_waves, be2.lp_count, be2.verify_fallbacks) == (
        be1.device_waves, be1.lp_count, be1.verify_fallbacks
    )
    lanes = two.backend_stats["device_lanes"]
    assert set(lanes) == {"cpu", "cpu:0"} and min(lanes.values()) > 0
    assert sum(lanes.values()) == be2.lp_count
    assert two.backend_stats["device_launches"] == {"cpu": 0, "cpu:0": 0}

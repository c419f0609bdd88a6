"""The port's mesh (parallel/mesh.py) and mesh scheduler
(engine/mesh_scheduler.py) on the CPU against the JAX package's on its
eight virtual CPU devices (tests/conftest.py): the port's twin is a mesh
over the CPU eight times.  Shapes, the distributed round, the bound
exchange and the scheduler's fronts and counts must be equal; twins of
tests/test_mesh.py on the bundled examples."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moip_aira_tpu.api import make_backend as ref_make_backend
from moip_aira_tpu.core.store import Solutions as RefSolutions
from moip_aira_tpu.engine.mesh_scheduler import MeshScheduler as RefMeshScheduler
from moip_aira_tpu.io import read_problem as ref_read_problem
from moip_aira_tpu.parallel import mesh as ref_mesh
from moip_aira_tpu.parallel.symgroup import sym_perms
from moip_aira_tpu_torch.api import make_backend, solve_front
from moip_aira_tpu_torch.core.store import Solutions
from moip_aira_tpu_torch.engine.mesh_scheduler import MeshScheduler
from moip_aira_tpu_torch.io import read_problem
from moip_aira_tpu_torch.parallel import mesh
from moip_aira_tpu_torch.solver.wave import WaveLexBackend

EX = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small batched ops: one intra-op thread is faster than a pool on a
    machine that runs several test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def need_eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("the reference needs 8 virtual devices (tests/conftest.py)")


def golden(name):
    rows = []
    with open(f"{EX}/{name}.out") as fh:
        for line in fh:
            parts = line.split()
            if parts and all(p.lstrip("-").isdigit() for p in parts):
                rows.append([int(p) for p in parts])
    return np.array(rows)


def cpu_mesh(n):
    return mesh.make_mesh(n, devices=[CPU] * 8)


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8])
def test_make_mesh_shapes(n):
    need_eight_devices()
    ref = ref_mesh.make_mesh(n)
    got = cpu_mesh(n)
    assert got.devices.shape == ref.devices.shape
    assert got.shape == dict(ref.shape)
    assert got.axis_names == tuple(ref.axis_names) == ("workers", "strips")
    assert got.size == ref.size == n
    assert all(d == CPU for d in got.domain_devices())


def test_make_mesh_defaults_to_what_is_visible():
    """Without a card the visible devices are one CPU, so any mesh is one
    domain, as the reference's is on one chip."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    m = mesh.make_mesh(8)
    assert m.size == 1 and m.devices.shape == (1, 1)
    assert m.domain_devices() == [CPU]


def test_distributed_round_2ap05():
    """Eight domains, one lane each: statuses, the gathered results and
    statuses (in the reference's gather order) and lo/hi equal the
    reference's; identity lanes give one end of the golden front, the
    reversed ordering the other."""
    need_eight_devices()
    rp, p = ref_read_problem(f"{EX}/G2AP05.lp"), read_problem(f"{EX}/G2AP05.lp")
    perms = sym_perms(p.objcnt)
    ref_m = ref_mesh.make_mesh(8)
    step_ref, B = ref_mesh.make_distributed_round(rp, ref_m, batch_per_device=1)
    step, B2 = mesh.make_distributed_round(p, cpu_mesh(8), batch_per_device=1)
    assert B == B2 == 8
    rhs = np.tile(p.initial_rhs(), (B, 1))
    perm = np.array([list(perms[i % len(perms)]) for i in range(B)])
    ref = [np.asarray(a) for a in step_ref(
        ref_mesh.shard_batch(ref_m, jnp.asarray(rhs)),
        ref_mesh.shard_batch(ref_m, jnp.asarray(perm.astype(np.int32))),
    )]
    got = [t.numpy() for t in step(rhs, perm)]
    for a, b in zip(got, ref):
        assert np.array_equal(a, b)
    status, results, all_status, lo, hi = got
    assert (all_status == 0).all()
    front = golden("G2AP05")
    ends = {tuple(front[0]), tuple(front[-1])}
    assert {tuple(r) for r in results} == ends
    assert lo[0].tolist() == front.min(0).tolist()
    assert hi[0].tolist() == front.max(0).tolist()


def test_bound_exchange_matches_reference():
    need_eight_devices()
    rng = np.random.default_rng(7)
    k, S = 3, 4
    boxes = rng.integers(-50, 50, size=(8 * S, k)).astype(np.float64)
    boxes[rng.random((8 * S, k)) < 0.1] = mesh.BIGVAL
    flags = (rng.random(8 * S) < 0.6).astype(np.int32)
    vals = rng.integers(0, 100, size=(8 * S, k)).astype(np.float64)
    vflags = (rng.random(8 * S) < 0.5).astype(np.int32)
    vflags[:S] = 0  # one domain with no value row
    ref_m = ref_mesh.make_mesh(8)
    ex_ref = ref_mesh.make_bound_exchange(ref_m, k, S)
    ref = [np.asarray(a) for a in ex_ref(
        *(ref_mesh.shard_batch(ref_m, jnp.asarray(a)) for a in (boxes, flags, vals, vflags))
    )]
    got = [t.numpy() for t in mesh.make_bound_exchange(cpu_mesh(8), k, S)(
        boxes, flags, vals, vflags
    )]
    for a, b in zip(got, ref):
        assert a.shape == b.shape and np.array_equal(a, b)
    # no value row anywhere: the sentinels
    none = np.zeros(8 * S, dtype=np.int32)
    _, _, lo, hi = mesh.make_bound_exchange(cpu_mesh(8), k, S)(boxes, flags, vals, none)
    assert (lo.numpy() == mesh.BIGVAL).all() and (hi.numpy() == -mesh.BIGVAL).all()


def run_both(mode, n_dev=8, slots=32):
    """G3AP05, 6 workers, numpy backend, on the reference's n_dev virtual
    devices and the port's CPU mesh of n_dev domains."""
    rp, p = ref_read_problem(f"{EX}/G3AP05.lp"), read_problem(f"{EX}/G3AP05.lp")
    ref_st, st = RefSolutions(rp.objcnt), Solutions(p.objcnt)
    ref = RefMeshScheduler(
        rp, ref_make_backend(rp, "numpy"), ref_mesh.make_mesh(n_dev), mode=mode, slots=slots
    )
    ref.run(6, True, ref_st)
    got = MeshScheduler(
        p, make_backend(p, "numpy"), cpu_mesh(n_dev), mode=mode, slots=slots
    )
    got.run(6, True, st)
    return ref, ref_st, got, st


COUNTERS = ("ip_count", "rounds", "batch_sizes", "exchanged_boxes",
            "carried_boxes", "severed", "domain_ips", "pre_ips")


@pytest.mark.parametrize(
    "mode,want",
    [
        ("strip", dict(ip_count=118, rounds=10, domain_ips=[19, 13, 7, 14, 13, 9], pre_ips=43)),
        ("sync", dict(ip_count=202, rounds=13, domain_ips=[33, 35, 35, 33, 33, 33], pre_ips=0)),
    ],
)
def test_mesh_scheduler_matches_reference(mode, want):
    need_eight_devices()
    ref, ref_st, got, st = run_both(mode)
    assert np.array_equal(st.sorted_unique_points(), golden("G3AP05"))
    assert np.array_equal(st.sorted_unique_points(), ref_st.sorted_unique_points())
    for key in COUNTERS:
        assert getattr(got, key) == getattr(ref, key), key
    for key, value in want.items():
        assert getattr(got, key) == value, key
    assert got.exchanged_boxes > 0
    if mode == "sync":
        assert got.severed > 0


def test_mesh_exchange_carry_over_unit():
    """More than `slots` new boxes in one round all propagate across later
    rounds in arrival order (tests/test_mesh.py:101-122)."""
    p = read_problem(f"{EX}/G2AP05.lp")
    ms = MeshScheduler(p, backend=None, mesh=None, slots=32)
    boxes = np.arange(80 * p.objcnt, dtype=np.float64).reshape(80, p.objcnt)
    sent = [ms._drain_pending(0, boxes)]
    sent.append(ms._drain_pending(0, np.zeros((0, p.objcnt))))
    sent.append(ms._drain_pending(0, np.zeros((0, p.objcnt))))
    assert [len(s) for s in sent] == [32, 32, 16]
    assert np.array_equal(np.vstack(sent), boxes)
    assert ms.carried_boxes == 48 + 16
    assert len(ms._drain_pending(1, boxes[:5])) == 5
    assert len(ms._drain_pending(0, boxes[:5])) == 5


def test_mesh_exchange_tiny_slots_parity():
    """A starved slot budget (slots=1) only defers the exchange: the same
    front, and the same counts as the reference's
    (tests/test_mesh.py:125-154)."""
    need_eight_devices()
    ref, ref_st, got, st = run_both("sync", n_dev=2, slots=1)
    assert np.array_equal(st.sorted_unique_points(), golden("G3AP05"))
    for key in COUNTERS:
        assert getattr(got, key) == getattr(ref, key), key
    assert got.carried_boxes > 0


def test_dryrun_twin_wave_on_an_eight_domain_cpu_mesh():
    """``__graft_entry__.dryrun_multichip(8)`` on the port: G3AP05, 6
    workers, the wave backend over eight CPU domains."""
    p = read_problem(f"{EX}/G3AP05.lp")
    be = WaveLexBackend(p, device="cpu", mesh=cpu_mesh(8))
    front = solve_front(p, n_workers=6, backend=be, device="cpu", mesh_devices=8, dp="off")
    assert np.array_equal(front.points, golden("G3AP05"))
    assert front.ip_count == 118 and front.rounds == 10
    assert front.domain_ips == [19, 13, 7, 14, 13, 9] and front.pre_ips == 43
    assert front.backend_stats["backend"] == "wave"


def test_one_domain_mesh_through_solve_front():
    """``mesh_devices`` on the CPU is one domain (one device): the reference's
    counts on one chip."""
    p = read_problem(f"{EX}/G3AP05.lp")
    front = solve_front(p, n_workers=6, backend="wave", device="cpu", mesh_devices=8, dp="off")
    assert np.array_equal(front.points, golden("G3AP05"))
    assert (front.ip_count, front.rounds, front.domain_ips, front.pre_ips) == (111, 8, [68], 43)


def test_wave_refuses_a_mesh_over_two_cards():
    p = read_problem(f"{EX}/G2AP05.lp")
    two = mesh.make_mesh(devices=[torch.device("cuda", 0), torch.device("cuda", 1)])
    assert two.size == 2
    with pytest.raises(NotImplementedError):
        WaveLexBackend(p, device="cpu", mesh=two)
    with pytest.raises(ValueError):
        WaveLexBackend(p, device="cpu", batch_width=255, mesh=cpu_mesh(2))

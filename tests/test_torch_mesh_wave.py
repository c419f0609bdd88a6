"""The wave backend over a mesh of several devices, on the CPU.

The mesh's domains name two device keys, ``torch.device("cpu")`` and
``torch.device("cpu", 0)``: distinct dict keys, so the wave builds one
kernel wrapper for each and splits every wave's lanes between them, as it
splits them over the cards of a multi-card mesh.  Every kernel's plain
version gives a lane the same bits whatever batch it runs in, so the split
mesh must give the one-key mesh's front and counts; on G3AP05 those are the
JAX package's on its eight virtual devices (tests/test_torch_mesh.py)."""

import functools
import os

import numpy as np
import pytest
import torch

from moip_aira_tpu_torch.api import solve_front
from moip_aira_tpu_torch.io import read_problem
from moip_aira_tpu_torch.parallel import mesh
from moip_aira_tpu_torch.solver.wave import WaveLexBackend

EX = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
CPU = torch.device("cpu")
CPU0 = torch.device("cpu", 0)
#: G3AP05, 6 workers, 8 domains: the reference's counts on 8 devices
G3AP05_COUNTS = (118, 10, [19, 13, 7, 14, 13, 9], 43)


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


def two_key_mesh(n):
    """n domains alternating over the two CPU keys, the first on ``CPU``."""
    return mesh.make_mesh(n, devices=[CPU, CPU0] * (n // 2))


@functools.lru_cache(maxsize=None)
def run(name, n_dom, split, workers, **kw):
    """The front of ``name`` through solve_front with the wave over an
    ``n_dom``-domain mesh, on one key or (``split``) two."""
    p = read_problem(f"{EX}/{name}.lp")
    m = two_key_mesh(n_dom) if split else mesh.make_mesh(n_dom, devices=[CPU] * n_dom)
    be = WaveLexBackend(p, device="cpu", mesh=m, **kw)
    front = solve_front(
        p, n_workers=workers, backend=be, device="cpu", mesh_devices=n_dom, dp="off"
    )
    return be, front


def run_g3ap05(split, fragments):
    return run("G3AP05", 8, split, 6, fragments=fragments)


@pytest.mark.parametrize("fragments", [False, True], ids=["per-lp", "fragments"])
def test_split_mesh_gives_the_one_device_front_and_counts(fragments):
    """(a) the per-LP path (K1's plain version), (b) the fragment path
    (K3's): the golden front, the reference's mesh counts, and the one-key
    mesh's waves, LPs, fallbacks and fragment records."""
    be1, one = run_g3ap05(False, fragments)
    be2, two = run_g3ap05(True, fragments)
    assert len(be2.lp_kernels) == 2 and len(be1.lp_kernels) == 1
    assert len(be2.frag_kernels) == (2 if fragments else 0)
    for front in (one, two):
        assert np.array_equal(front.points, golden("G3AP05"))
        assert (front.ip_count, front.rounds, front.domain_ips, front.pre_ips) == G3AP05_COUNTS
    for key in ("device_waves", "lp_count", "verify_fallbacks"):
        assert getattr(be2, key) == getattr(be1, key), key
    assert two.backend_stats["device_waves"] == one.backend_stats["device_waves"]
    if fragments:
        for key in ("records", "host_recs", "reopened", "lanes", "waves", "ticks",
                    "dev_iters", "why"):
            assert be2.frag_stats[key] == be1.frag_stats[key], key
    # the lanes ran on both keys, in proportion to their domains
    lanes = be2.device_lanes
    assert lanes["cpu"] > 0 and lanes["cpu:0"] > 0
    assert lanes["cpu"] >= lanes["cpu:0"]


def test_split_mesh_on_the_revised_engine_with_warm_starts():
    """(c) K2's plain version with warm starts (engine="revised") on G2AP05
    over four domains: the warm bases come back in lane order, so the split
    mesh walks the one-key mesh's trees."""
    be1, one = run("G2AP05", 4, False, 2, engine="revised")
    be2, two = run("G2AP05", 4, True, 2, engine="revised")
    assert be2.engine == "revised" and be2.warm_start
    for front in (one, two):
        assert np.array_equal(front.points, golden("G2AP05"))
    assert (two.ip_count, two.rounds, two.domain_ips, two.pre_ips) == (
        one.ip_count, one.rounds, one.domain_ips, one.pre_ips
    )
    for key in ("device_waves", "lp_count", "verify_fallbacks"):
        assert getattr(be2, key) == getattr(be1, key), key
    assert min(be2.device_lanes.values()) > 0


@pytest.mark.parametrize(
    "lanes,weights",
    [(0, [4, 4]), (1, [4, 4]), (2, [1, 1, 1]), (7, [4, 4]), (256, [4, 4]),
     (10, [3, 1]), (5, [1, 2, 1]), (33, [1, 1, 1, 1, 1, 1, 1, 1])],
)
def test_lane_chunks_split_in_order_and_in_proportion(lanes, weights):
    """(d) every lane exactly once, in order; each chunk within one lane of
    its share; the first chunks take what is left over."""
    chunks = mesh.lane_chunks(lanes, weights)
    assert len(chunks) == len(weights)
    assert [i for a, b in chunks for i in range(a, b)] == list(range(lanes))
    total = sum(weights)
    for (a, b), w in zip(chunks, weights):
        assert abs((b - a) - lanes * w / total) < 1
    sizes = [b - a for a, b in chunks]
    if lanes < len(weights) and len(set(weights)) == 1:
        assert sizes == [1] * lanes + [0] * (len(weights) - lanes)


def test_lane_chunks_refuse_a_weightless_group():
    with pytest.raises(ValueError):
        mesh.lane_chunks(4, [2, 0])


def test_a_device_with_no_lane_is_not_called():
    """(d) a wave of one lane over two devices runs on the first device
    only; the second device's wrapper is never called, and the outputs come
    back in the one-device wave's bits."""
    p = read_problem(f"{EX}/G2AP05.lp")
    be = WaveLexBackend(p, device="cpu", mesh=two_key_mesh(4))
    ref = WaveLexBackend(p, device="cpu")
    calls = {str(d): 0 for d in be.lp_kernels}

    def counted(dev, kern):
        def call(*a):
            calls[str(dev)] += 1
            return kern(*a)
        return call

    be.lp_kernels = {d: counted(d, k) for d, k in be.lp_kernels.items()}
    nc, m = be.n + be.m, be.m
    rng = np.random.default_rng(0)
    for nb, want in ((1, {"cpu": 1, "cpu:0": 0}), (5, {"cpu": 2, "cpu:0": 1})):
        c = np.zeros((nb, nc))
        c[:, : be.n] = p.C[rng.integers(p.objcnt, size=nb)]
        lo = np.tile(np.concatenate([p.lb, p.row_lb, np.full(p.objcnt, -np.inf)]), (nb, 1))
        hi = np.tile(np.concatenate([p.ub, p.row_ub, np.full(p.objcnt, np.inf)]), (nb, 1))
        wb = np.full((nb, m), -1, dtype=np.int32)
        wa = np.zeros((nb, nc), dtype=np.int32)
        *got, done = be._device_lp(c, lo, hi, wb, wa)
        *exp, _ = ref._device_lp(c, lo, hi, wb, wa)
        assert done == []
        for g, e in zip(got, exp):
            assert g.shape[0] == nb and torch.equal(g, e)
        assert calls == want
    assert be.device_lanes == {"cpu": 4, "cpu:0": 2}


@pytest.mark.parametrize("fragments", [False, True], ids=["per-lp", "fragments"])
def test_device_counters_sum_to_the_totals(fragments):
    """(e) device_lanes sums to the LPs (per-LP path) or the fragment lanes,
    device_launches to kernel_launches (0 here: the CPU runs the plain
    versions, which launch nothing); without a mesh one device holds all."""
    be, front = run_g3ap05(True, fragments)
    st = front.backend_stats
    assert set(st["device_lanes"]) == set(st["device_launches"]) == {"cpu", "cpu:0"}
    lanes = be.frag_stats["lanes"] if fragments else st["lp_count"]
    assert sum(st["device_lanes"].values()) == lanes
    assert sum(st["device_launches"].values()) == st["kernel_launches"] == 0
    be1, one = run_g3ap05(False, fragments)
    assert one.backend_stats["device_lanes"] == {"cpu": lanes}
    assert one.backend_stats["device_launches"] == {"cpu": 0}


def test_device_counters_without_a_mesh():
    p = read_problem(f"{EX}/G2AP05.lp")
    front = solve_front(p, backend="wave", device="cpu", dp="off")
    st = front.backend_stats
    assert st["device_lanes"] == {"cpu": st["lp_count"]} and st["lp_count"] > 0
    assert st["device_launches"] == {"cpu": 0} == {"cpu": st["kernel_launches"]}


def test_distributed_round_over_two_keys_equals_one_key():
    """(f) make_distributed_round with the domains on two device keys runs
    one lex kernel per key and gives the one-key round's outputs."""
    p = read_problem(f"{EX}/G2AP05.lp")
    m1 = mesh.make_mesh(4, devices=[CPU] * 4)
    m2 = two_key_mesh(4)
    assert [d for d, _ in mesh.by_device(m2)] == [CPU, CPU0]
    step1, B = mesh.make_distributed_round(p, m1)
    step2, B2 = mesh.make_distributed_round(p, m2)
    assert B == B2 == 8
    k = p.objcnt
    rhs = np.tile(p.initial_rhs(), (B, 1))
    perm = np.array([list(range(k)) if i % 2 == 0 else list(range(k))[::-1] for i in range(B)])
    got1 = [t.numpy() for t in step1(rhs, perm)]
    got2 = [t.numpy() for t in step2(rhs, perm)]
    for a, b in zip(got1, got2):
        assert a.shape == b.shape and np.array_equal(a, b)
    status, results = got2[0], got2[1]
    assert (status == 0).all()
    front = golden("G2AP05")
    assert {tuple(r) for r in results} == {tuple(front[0]), tuple(front[-1])}

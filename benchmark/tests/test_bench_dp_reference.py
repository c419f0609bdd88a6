"""The knapsack's reference, the dynamic programme of ``reference_dp.py``:
equal to enumeration wherever enumeration reaches, each point backed by its
witness beyond, strict enough that ``judge`` fails a wrong front against
it, and giving the accepted configurations the fronts that enumeration
gave them."""

import dataclasses
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import control
import instances
import judge
import reference
import reference_dp
import registry

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
KP10 = registry.load_json(BENCH / "configs" / "kirlik-3kp-n10.json")
#: sha256 of the accepted configurations' reference fronts, each front's
#: int64 bytes and a "|", taken when every front came from enumeration
FRONT_DIGESTS = {
    "kirlik-3kp-n10": "bad029b7c61ee68f3c0dca3a0a701f7be598844f3674914174c5ae4892303c45",
    "kirlik-3ap-n10": "089f570f5496337d1e68761667be2d8f2f105bd0c8e6712f717f4d4c77aeb6b4",
}
CAPACITIES = {"zero": lambda w: 0.0, "half": lambda w: w.sum() / 2,
              "all": lambda w: float(w.sum())}


def enumerated(values, weights, capacity, weak):
    return reference.nondominated(reference.kp_points(values, weights, capacity), "max", weak)


@pytest.mark.parametrize("capacity", sorted(CAPACITIES))
@pytest.mark.parametrize("k", [2, 3, 4, 5])
def test_dp_equals_enumeration(k, capacity):
    """n = 1-14 on three generator seeds: values and weights from 0-2 (ties
    and zero-value items on every seed; enumeration's grid path), up to
    n = 11 from 0-99 (its pairwise path), and up to n = 8 from 0-99,999
    (values packed in two words from k = 4)."""
    seen_tie = False
    for seed in range(3):
        rng = np.random.default_rng([k, seed])
        for hi, sizes in ((3, range(1, 15)), (100, range(1, 12)), (100_000, range(1, 9))):
            for n in sizes:
                V = rng.integers(0, hi, size=(k, n))
                w = rng.integers(0, hi, size=n)
                cap = CAPACITIES[capacity](w)
                fronts = {}
                for weak in (False, True):
                    fronts[weak] = enumerated(V, w, cap, weak)
                    dp, _ = reference_dp.kp_front(V, w, cap, "max", weak)
                    np.testing.assert_array_equal(dp, fronts[weak])
                seen_tie |= len(fronts[True]) > len(fronts[False])
    assert seen_tie or capacity == "zero"


def test_dp_equals_enumeration_on_the_kirlik_3kp_n10_set():
    for inst in instances.instance_set(KP10):
        for weak in (False, True):
            np.testing.assert_array_equal(
                reference.front(inst, weak),
                enumerated(inst.values, inst.weights, inst.capacity, weak))


def test_dp_equals_enumeration_when_minimising():
    rng = np.random.default_rng(5)
    V, w = rng.integers(0, 20, size=(3, 10)), rng.integers(0, 20, size=10)
    pts = reference.kp_points(V, w, 40.0)
    for weak in (False, True):
        np.testing.assert_array_equal(reference_dp.kp_front(V, w, 40.0, "min", weak)[0],
                                      reference.nondominated(pts, "min", weak))


@pytest.mark.parametrize("n,k,seed,capacity_frac", [
    (20, 4, 1, 0.5), (20, 5, 2, 0.5), (24, 3, 3, 0.5), (30, 3, 1, 0.5), (30, 2, 4, 0.5),
    (70, 2, 5, 0.1),  # witnesses of two words
])
def test_dp_points_follow_from_their_witnesses(n, k, seed, capacity_frac):
    """Beyond enumeration: every point is feasible and given by its subset,
    no point dominates another, and each feasible subset drawn at random
    (items in a random order, each taken while it fits) is matched or beaten
    by a point."""
    _, V, w, cap = instances.kp_lp(n, k, seed, capacity_frac=capacity_frac)
    points, X = reference_dp.kp_front(V, w, cap, "max")
    assert n <= 64 or X[:, 64:].any()
    assert X.shape == (len(points), n) and set(np.unique(X)) <= {0, 1}
    assert np.all(X @ w <= cap)
    np.testing.assert_array_equal(X @ V.T, points)
    ge = (points[:, None, :] >= points[None, :, :]).all(axis=2)
    assert np.array_equal(ge, np.eye(len(points), dtype=bool))
    rng = np.random.default_rng(seed)
    for _ in range(300):
        x = np.zeros(n, dtype=np.int64)
        load = 0
        for i in rng.permutation(n):
            if load + w[i] <= cap:
                x[i], load = 1, load + w[i]
        p = V @ x
        assert (points >= p).all(axis=1).any()


def kp_cut(size, count=3):
    return {**KP10, "size": size, "instances": count}


def test_judge_fails_a_front_with_a_point_left_out():
    insts = instances.instance_set(kp_cut(20))
    ref = {i: reference.front(inst) for i, inst in enumerate(insts)}
    fronts = [(i, f[1:]) for i, f in ref.items()]
    checks, wrong = judge.compare(fronts, ref)
    assert not judge.passes(checks) and checks["points_wrong"]["value"] == len(ref)
    assert wrong == len(ref)


def test_judge_fails_a_front_with_a_dominated_point_added():
    insts = instances.instance_set(kp_cut(20))
    ref = {i: reference.front(inst) for i, inst in enumerate(insts)}
    fronts = [(i, np.concatenate([f, f[:1] - np.eye(1, f.shape[1], dtype=np.int64)]))
              for i, f in ref.items()]
    checks, _ = judge.compare(fronts, ref)
    assert not judge.passes(checks) and checks["points_wrong"]["value"] == len(ref)


def test_the_control_is_not_correct_under_the_dp_reference():
    for seed, checks, correct in control.readings(kp_cut(20), [1, 2, 3]):
        assert not correct and checks["points_wrong"]["value"] > 0


def test_accepted_configurations_keep_their_fronts():
    files = {c["name"]: c["file"] for c in registry.load_benchmark()["configs"]}
    for name, expected in FRONT_DIGESTS.items():
        config = registry.load_json(ROOT / files[name])
        digest = hashlib.sha256()
        for inst in instances.instance_set(config):
            digest.update(np.ascontiguousarray(reference.front(inst), dtype=np.int64).tobytes())
            digest.update(b"|")
        assert digest.hexdigest() == expected, name


def test_the_front_takes_the_family_s_route():
    """A knapsack's front is the dynamic programme's, an assignment's is
    enumeration's, and no other family has one."""
    kp = instances.make_instance({**KP10, "size": 8}, 3)
    np.testing.assert_array_equal(
        reference.front(kp), reference_dp.kp_front(kp.values, kp.weights, kp.capacity, "max")[0])
    ap = instances.make_instance({"name": "t", "family": "assignment", "objectives": 2,
                                  "size": 4}, 1)
    for weak in (False, True):
        np.testing.assert_array_equal(reference.front(ap, weak),
                                      reference.nondominated(reference.ap_points(ap.costs),
                                                             ap.sense, weak))
    with pytest.raises(ValueError):
        reference.front(dataclasses.replace(ap, family="flow"))


def test_the_dp_module_loads_nothing_of_either_package():
    code = ("import sys; sys.path.insert(0, %r); import reference_dp; "
            "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('moip_aira_tpu')))"
            % str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_run_py_on_a_cut_knapsack_cell_on_the_cpu():
    """A whole run on the CPU, its fronts judged against the dynamic
    programme's."""
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", "3kp10-lex-sync2",
         "--seed", str(2**31 + 19), "--seconds", "0.5", "--trace", "0", "--device", "cpu",
         "--cut", "size=4", "--cut", "instances=2"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 2
    assert "check points_wrong: 0 (limit 0)" in proc.stderr

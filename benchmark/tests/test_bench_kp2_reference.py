"""The reference for knapsacks with two objectives, the dense tables of
``reference_kp2.py``: equal to enumeration and to ``reference_dp``, strong
and weak, wherever those reach; its value axis the objective the program's
K4 does not put there; the route ``reference.front`` gives it; and no import
of either package or of JAX."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import instances
import reference
import reference_dp
import reference_kp2

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
#: value and weight draws, each with the sizes enumeration takes at it: the
#: benchmark generator's narrow 60-100 and the published type A's 1-1000
RANGES = {"60-100": ((60, 101), (1, 2, 5, 9, 12, 16)),
          "1-1000": ((1, 1001), (1, 2, 4, 7, 10))}
#: capacities: below the lightest item, at 0, half the weights, above them all
CAPACITIES = {"below_lightest": lambda w: float(w.min()) - 1, "zero": lambda w: 0.0,
              "half": lambda w: w.sum() / 2, "above_all": lambda w: float(w.sum()) + 7.5}


def enumerated(V, w, cap, sense, weak):
    return reference.nondominated(reference.kp_points(V, w, cap), sense, weak)


def draws(draw, seed):
    """Seeded instances of each size: values (2, n) and weights (n,); the
    second value row a permutation of the first in every other instance, so
    that the two sums tie, and in every third the first item twice, so that
    two subsets give each point that holds one of the pair."""
    (lo, hi), sizes = RANGES[draw]
    rng = np.random.default_rng([seed, lo, hi])
    for i, n in enumerate(sizes):
        V = rng.integers(lo, hi, size=(2, n))
        w = rng.integers(lo, hi, size=n)
        if i % 2:
            V[1] = rng.permutation(V[0])
        if i % 3 == 2:
            V[:, 1], w[1] = V[:, 0], w[0]
        yield V, w


@pytest.mark.parametrize("sense", ["max", "min"])
@pytest.mark.parametrize("draw", sorted(RANGES))
def test_equals_enumeration_and_the_item_programme(draw, sense):
    seen_weak_only = False
    for seed in range(2):
        for V, w in draws(draw, seed):
            for capacity in CAPACITIES.values():
                cap = capacity(w)
                for weak in (False, True):
                    got = reference_kp2.kp_front(V, w, cap, sense, weak, device="cpu")
                    want = enumerated(V, w, cap, sense, weak)
                    np.testing.assert_array_equal(got, want)
                    np.testing.assert_array_equal(
                        got, reference_dp.kp_front(V, w, cap, sense, weak)[0])
                    assert got.dtype == np.int64 and got.shape[1] == 2
                strict = reference_kp2.kp_front(V, w, cap, sense, device="cpu")
                seen_weak_only |= len(want) > len(strict)
    # the weak set differed from the front somewhere, at the narrow draws
    assert seen_weak_only or draw == "1-1000" or sense == "min"


def test_ties_and_repeated_items_are_drawn():
    """The draws hold instances whose two value sums tie and instances with
    an item twice."""
    pairs = list(draws("1-1000", 0))
    assert any(V[0].sum() == V[1].sum() for V, _ in pairs)
    assert any(len(w) > 2 and w[0] == w[1] and (V[:, 0] == V[:, 1]).all() for V, w in pairs)


def test_a_capacity_below_every_item_leaves_the_empty_set():
    V, w = np.array([[5, 7], [3, 9]]), np.array([4, 6])
    for sense in ("max", "min"):
        for weak in (False, True):
            np.testing.assert_array_equal(
                reference_kp2.kp_front(V, w, 3.0, sense, weak, device="cpu"), [[0, 0]])
    assert reference_kp2.kp_front(V, w, -1.0, "max", device="cpu").shape == (0, 2)


@pytest.mark.parametrize("n,seed,capacity_frac", [(24, 1, 0.5), (30, 2, 0.5), (30, 3, 0.3)])
def test_equals_the_item_programme_beyond_enumeration(n, seed, capacity_frac):
    _, V, w, cap = instances.kp_lp(n, 2, seed, capacity_frac=capacity_frac)
    for weak in (False, True):
        np.testing.assert_array_equal(
            reference_kp2.kp_front(V, w, cap, "max", weak, device="cpu"),
            reference_dp.kp_front(V, w, cap, "max", weak)[0])


def test_blocks_of_rows_give_the_whole_table(monkeypatch):
    """Blocks of one row each, the most the in-place update can be cut, give
    what one block of the whole table gives."""
    _, V, w, cap = instances.kp_lp(12, 2, 4, vlo=1, vhi=1001)
    whole = [reference_kp2.kp_front(V, w, cap, "max", weak, device="cpu") for weak in (0, 1)]
    monkeypatch.setattr(reference_kp2, "BLOCK_CELLS", 1)
    for weak in (0, 1):
        np.testing.assert_array_equal(
            reference_kp2.kp_front(V, w, cap, "max", bool(weak), device="cpu"), whole[weak])


def test_signed_values_and_zero_weights():
    """Values below 0 and items of weight 0 (``sweep``'s shifts of either
    sign): equal to enumeration."""
    rng = np.random.default_rng(11)
    for _ in range(12):
        V = rng.integers(-30, 31, size=(2, 9))
        w = rng.integers(0, 20, size=9)
        for sense in ("max", "min"):
            for weak in (False, True):
                np.testing.assert_array_equal(
                    reference_kp2.kp_front(V, w, w.sum() / 2, sense, weak, device="cpu"),
                    enumerated(V, w, w.sum() / 2, sense, weak))


def test_the_value_axis_is_the_one_k4_does_not_take(tmp_path):
    """On the cell's own draws (the sums differ) and on draws whose sums
    tie, the reference's value axis is the objective the program's
    ``detect_kp2`` leaves off its s-axis."""
    from moip_aira_tpu_torch.io import read_problem
    from moip_aira_tpu_torch.solver.kp_front import detect_kp2

    texts = [instances.kp_lp(100, 2, seed, vlo=1, vhi=1001)[0] for seed in (1, 2, 3)]
    tie = "maximize 0\n\nsubject to\n3 x0 + 4 x1 + 5 x2 <= 6\n\n" \
          "7 x0 + 2 x1 + 5 x2 > 1\n5 x0 + 7 x1 + 2 x2 > 2\n\nBINARY\nx0 x1 x2\nEND\n"
    axes = set()
    for i, text in enumerate(texts + [tie]):
        path = tmp_path / f"kp{i}.lp"
        path.write_text(text)
        port = detect_kp2(read_problem(str(path))).s_axis
        inst = reference.instance_from_lp(text)
        ours = reference_kp2.value_axis(inst.values[:, inst.weights <= inst.capacity])
        assert ours == 1 - port
        axes.add(ours)
    assert axes == {0, 1}


def test_two_objective_knapsacks_take_the_dense_tables(monkeypatch):
    """``reference.front``: a knapsack with two objectives takes
    ``reference_kp2``, one with three ``reference_dp``."""
    kp2 = instances.make_instance({"name": "t", "family": "knapsack", "objectives": 2,
                                   "size": 10}, 2)
    kp3 = instances.make_instance({"name": "t", "family": "knapsack", "objectives": 3,
                                   "size": 8}, 2)
    calls = []
    for module in (reference_kp2, reference_dp):
        def spy(*args, _orig=module.kp_front, _name=module.__name__, **kw):
            calls.append(_name)
            return _orig(*args, **kw)

        monkeypatch.setattr(module, "kp_front", spy)
    for weak in (False, True):
        reference.front(kp2, weak)
        reference.front(kp3, weak)
    assert calls == ["reference_kp2", "reference_dp"] * 2


def test_imports_neither_package_nor_jax():
    """Statically, by the module's import statements, and by what importing
    it loads."""
    tree = ast.parse((BENCH / "reference_kp2.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "math", "numpy", "torch"}, names
    code = ("import sys; sys.path.insert(0, %r); import reference_kp2; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'moip_aira_tpu', 'moip_aira_tpu_torch'}))" % str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"

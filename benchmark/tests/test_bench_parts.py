"""The harness finds its parts by name, its generator is the port's
arithmetic, and its reference reproduces the bundled goldens."""

import json
import re
from pathlib import Path

import numpy as np
import pytest

import devtrace
import instances
import reference
import registry

ROOT = Path(__file__).resolve().parents[2]
EXAMPLES = ROOT / "examples"
BENCH = registry.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for entry in BENCH["configs"] + BENCH["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    names = [e["name"] for e in BENCH["configs"] + BENCH["workloads"] + metrics]
    assert len(names) == len(set(names))
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cells_found_by_name(cell):
    c = registry.find_cell(cell)
    assert c.chips == 1
    assert c.config["name"] == c.entry["config"]
    assert c.traffic["name"] == c.entry["traffic"]
    assert len(instances.instance_set(c.config)) == c.config["instances"]
    e2e = {m.name for m in registry.metrics_for(cell, "end_to_end")}
    layer = registry.metrics_for(cell, "per_layer")
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for m in layer:
        assert entries[m.name]["moves"] in e2e


@pytest.mark.parametrize("entry", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda e: e["name"])
def test_metric_reader_matches_its_entry(entry):
    module = registry.load_reader(entry["name"])
    assert module.UNIT == entry["unit"]
    if "layer" in entry:
        assert (module.LAYER, module.MOVES) == (entry["layer"], entry["moves"])
    assert callable(module.read)


def test_config_files_hold_what_benchmark_json_says():
    for c in BENCH["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert c["file"].startswith(BENCH["paths"][0] + "/")


@pytest.mark.parametrize("seed", [1, 7, 2**31 + 5])
def test_generator_is_deterministic_and_the_ports(seed):
    from moip_aira_tpu_torch.utils.generate import ap_lp, kp_lp

    for family, size in (("knapsack", 10), ("assignment", 6)):
        cfg = {"name": "t", "family": family, "objectives": 3, "size": size}
        a, b = instances.make_instance(cfg, seed), instances.make_instance(cfg, seed)
        assert a.text == b.text
        port = kp_lp(size, 3, seed) if family == "knapsack" else ap_lp(size, 3, seed)
        assert a.text == port
        # the benchmark's own reading of the text gives back the data
        parsed = reference.instance_from_lp(a.text)
        if family == "knapsack":
            assert np.array_equal(parsed.values, a.values)
            assert np.array_equal(parsed.weights, a.weights)
            assert parsed.capacity == a.capacity
        else:
            assert np.array_equal(parsed.costs, a.costs)


def test_cycles_are_permutations_drawn_from_the_seed():
    a, b = instances.cycle_orders(10, 3), instances.cycle_orders(10, 3)
    first = [next(a) for _ in range(3)]
    assert first == [next(b) for _ in range(3)]
    assert all(sorted(c) == list(range(10)) for c in first)
    assert first[0] != next(instances.cycle_orders(10, 4))


@pytest.mark.parametrize("name", ["G3KP10", "G3AP05"])
def test_reference_reproduces_the_bundled_goldens(name):
    inst = reference.instance_from_lp((EXAMPLES / f"{name}.lp").read_text(), name)
    gold = reference.read_out((EXAMPLES / f"{name}.out").read_text())
    got = reference.front(inst)
    assert {tuple(p) for p in got} == {tuple(p) for p in gold}
    if name == "G3KP10":
        assert len(got) == 18


@pytest.mark.parametrize("sense", ["min", "max"])
def test_grid_and_pairwise_fronts_agree(sense):
    rng = np.random.default_rng(5)
    pts = rng.integers(0, 40, size=(3000, 3))
    grid = reference.nondominated(pts, sense)
    lo = -pts if sense == "max" else pts
    pair = reference._pairwise_front(np.unique(lo, axis=0), False)
    pair = -pair if sense == "max" else pair
    assert {tuple(p) for p in grid} == {tuple(p) for p in pair}
    weak = reference.nondominated(pts, sense, weak=True)
    assert {tuple(p) for p in grid} <= {tuple(p) for p in weak}


def test_ap_points_lists_every_assignment_once():
    rng = np.random.default_rng(2)
    costs = rng.integers(0, 20, size=(2, 5, 5))
    import itertools

    want = sorted(
        tuple(int(sum(costs[o, i, p[i]] for i in range(5))) for o in range(2))
        for p in itertools.permutations(range(5))
    )
    assert sorted(map(tuple, reference.ap_points(costs).tolist())) == want


def test_trace_summary_union_and_gaps():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.window", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "bench.solve", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "bench.lex_call", "ts": 40, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "lex_bnb_kernel<0>", "ts": 10, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "lex_bnb_kernel<0>", "ts": 20, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 60, "dur": 5},
    ]
    s = devtrace.summarise(ev)
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(35e-6)
    assert s.op_seconds("lex_bnb") == pytest.approx(40e-6)
    # gaps 0-10 and 65-100 under solve, 40-60 under lex_call
    assert s.idle_by_span["solve"] == pytest.approx(45e-6)
    assert s.idle_by_span["lex_call"] == pytest.approx(20e-6)

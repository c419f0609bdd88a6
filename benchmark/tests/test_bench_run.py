"""``run.py`` end to end on the CPU at a tiny cut, its comparison against a
broken timed path and against the control, its whole-name import check, and
a short run of each cell on the card."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import control
import registry
import run

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
CELLS = [w["name"] for w in registry.load_benchmark()["workloads"]]
#: a cut the CPU's plain loop finishes in about a second a front
TINY = {"size": 3, "instances": 2}


def tiny(cell):
    c = registry.find_cell(cell)
    c.config = {**c.config, **TINY}
    return c


def route(cell) -> str:
    """The program's route a cell's traffic takes: the dense dynamic
    programme ("dp", K4) or the AIRA engine on the lex backend ("lex", K6)."""
    return "dp" if registry.find_cell(cell).traffic["dp"] == "on" else "lex"


CUT = [a for k, v in TINY.items() for a in ("--cut", f"{k}={v}")]


def test_run_py_end_to_end_on_the_cpu(tmp_path):
    cell = CELLS[0]
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", cell, "--seed", str(2**31 + 11),
         "--seconds", "0.5", "--trace", "0", "--device", "cpu", *CUT,
         "--fronts-out", str(tmp_path / "fronts.jsonl")],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 2
    assert set(line["metrics"]) == {m.name for m in registry.metrics_for(cell, "end_to_end")}
    assert "check points_wrong: 0 (limit 0)" in proc.stderr
    fronts = [json.loads(x) for x in (tmp_path / "fronts.jsonl").read_text().splitlines()]
    assert len(fronts) == line["attempted"] and all(f["ips"] > 0 for f in fronts)


@pytest.mark.parametrize("cell", [c for c in CELLS if route(c) == "dp"])
def test_a_dp_cell_takes_the_dense_programme_on_the_cpu(cell, tmp_path):
    """Every front of the run came from the dense dynamic programme: its
    table was counted, it solved no IP, and on the CPU its plain version
    made no K4 launch (on the card, one an item)."""
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", cell, "--seed", str(2**31 + 13),
         "--seconds", "0.5", "--trace", "0", "--device", "cpu", *CUT,
         "--fronts-out", str(tmp_path / "fronts.jsonl")],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["attempted"] >= 2
    fronts = [json.loads(x) for x in (tmp_path / "fronts.jsonl").read_text().splitlines()]
    assert len(fronts) == line["attempted"]
    for f in fronts:
        assert f["table_cells"] > 0 and f["ips"] == 0 and f["kernel_launches"] == 0


def test_run_py_without_the_program_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / BENCH.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, str(tmp_path / BENCH.name / "run.py"), "--workload", CELLS[0],
         "--seed", "1", "--seconds", "0.5", "--trace", "0", "--device", "cpu", *CUT],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is there")
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", CELLS[0], "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def alter_answer(monkeypatch):
    """K6's plain version with one lane's answer altered where it is made."""
    from moip_aira_tpu_torch.solver import lex_torch

    orig = lex_torch.LexKernel.__call__

    def altered(self, rhs, perm):
        status, results, ips = orig(self, rhs, perm)
        results = results.clone()
        results[0, 0] += 1
        return status, results, ips

    monkeypatch.setattr(lex_torch.LexKernel, "__call__", altered)


def drop_half_the_batch(monkeypatch):
    """The lex backend answering only the first half of each batch and
    calling the rest infeasible."""
    from moip_aira_tpu_torch.solver import lex_torch
    from moip_aira_tpu_torch.solver.lex import LexOutcome
    from moip_aira_tpu_torch.solver.status import SolveStatus

    orig = lex_torch.TorchLexBackend._solve_chunk

    def half(self, reqs):
        keep = (len(reqs) + 1) // 2
        out = orig(self, reqs[:keep])
        return out + [LexOutcome(SolveStatus.INFEASIBLE, None, 1) for _ in reqs[keep:]]

    monkeypatch.setattr(lex_torch.TorchLexBackend, "_solve_chunk", half)


def alter_row_reading(monkeypatch):
    """The dense dynamic programme's front read off its answer row with one
    point's value altered."""
    from moip_aira_tpu_torch.solver import kp_front

    orig = kp_front._extract_front

    def altered(last_row, kp):
        points = orig(last_row, kp).copy()
        points[0, 0] += 1
        return points

    monkeypatch.setattr(kp_front, "_extract_front", altered)


def drop_the_last_item(monkeypatch):
    """The dense dynamic programme run over every item but the last."""
    from moip_aira_tpu_torch.solver import kp_front

    orig = kp_front.dp_items
    monkeypatch.setattr(kp_front, "dp_items", lambda kp, device: orig(kp, device)[:, :-1])


#: the faults the timed path of each route can have, each planted where it
#: works
FAULTS = {
    "lex": [("answer_altered", alter_answer), ("half_batch_left_out", drop_half_the_batch)],
    "dp": [("row_reading_altered", alter_row_reading), ("last_item_left_out", drop_the_last_item)],
}


@pytest.mark.parametrize("cell,fault", [
    pytest.param(cell, fault, id=f"{name}-{cell}")
    for cell in CELLS for name, fault in FAULTS[route(cell)]
])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    result, fronts = run.run_cell(tiny(cell), seed=3, seconds=0.0, trace=False, device="cpu")
    assert result["correct"] is False
    assert result["checks"]["points_wrong"]["value"] > 0 or result["failed"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    config = registry.find_cell(cell).config
    # sizes at which some point of every set is weakly but not strictly
    # nondominated; two objectives drawn on 1-1000 rarely tie there, so a
    # knapsack with two takes the narrow draws on 60-100 of the others
    config = {**config, "size": 8 if config["family"] == "knapsack" else 4, "instances": 3}
    if config["family"] == "knapsack" and config["objectives"] == 2:
        config["generator"] = {**config["generator"], "vlo": 60, "vhi": 101}
    for seed, checks, correct in control.readings(config, [1, 2, 3]):
        assert not correct and checks["points_wrong"]["value"] > 0


def test_import_check_compares_whole_top_level_names(monkeypatch):
    for name in ("moip_aira_tpu_torch", "moip_aira_tpu_torch.api", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    found = run.forbidden_modules()
    assert "moip_aira_tpu" not in found and "jax" not in found and "flax" not in found
    monkeypatch.setitem(sys.modules, "moip_aira_tpu.api", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert {"moip_aira_tpu", "jaxlib"} <= set(run.forbidden_modules())


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys; sys.argv = ['run.py']; sys.path.insert(0, %r); import run; "
        "import moip_aira_tpu_torch.api, moip_aira_tpu_torch.solver.lex_torch, "
        "moip_aira_tpu_torch.io; print(run.forbidden_modules())" % str(BENCH)
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_runs_correct_on_the_card(card, cell):
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", cell, "--seed", "12345",
         "--seconds", "1", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert line["device"]["busy_s"] > 0
    rooflines = [m.name for m in registry.metrics_for(cell, "per_layer")
                 if m.name.endswith("_roofline")]
    assert rooflines
    for name in rooflines:
        assert 0 < line["metrics"][name]["value"] <= 100

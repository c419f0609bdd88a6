"""``run.py`` end to end on the CPU at a tiny cut, its comparison against a
broken timed path and against the control, its whole-name import check, and
a short run of each cell on the card."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
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


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [alter_answer, drop_half_the_batch],
                         ids=["answer_altered", "half_batch_left_out"])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    result, fronts = run.run_cell(tiny(cell), seed=3, seconds=0.0, trace=False, device="cpu")
    assert result["correct"] is False
    assert result["checks"]["points_wrong"]["value"] > 0 or result["failed"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    config = registry.find_cell(cell).config
    # sizes at which some point of every set is weakly but not strictly
    # nondominated
    config = {**config, "size": 8 if config["family"] == "knapsack" else 4, "instances": 3}
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
    assert np.isfinite(line["metrics"]["k6_roofline"]["value"])

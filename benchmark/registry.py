"""Finding a cell's parts by name.

``BENCHMARK.json`` at the root of the checkout names the cells, the
configurations and the metrics.  A cell's configuration is the JSON file its
``configs`` entry names, its traffic mix is ``traffic/<traffic>.json`` and
each metric is read by ``metrics/<name>.py`` beside this file.  A later cell,
configuration or metric is added as files and entries; nothing here names
one."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Metric:
    name: str
    unit: str
    read: object  # read(run) -> float | None


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    entry: dict


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def find_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    entry = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[entry["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    return Cell(name, int(entry["chips"]), config, traffic, entry)


def load_reader(name: str):
    """The module ``metrics/<name>.py``: ``read(run)``, ``UNIT``,
    ``LAYER`` and ``MOVES``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metrics_for(cell: str, kind: str, root: Path = ROOT) -> list:
    """The metrics of ``kind`` ("end_to_end" or "per_layer") that ``cell``
    reports, each with its reader; a reader whose unit, layer or moves
    differ from BENCHMARK.json's entry is refused."""
    out = []
    for entry in load_benchmark(root)[kind]:
        module = load_reader(entry["name"])
        for key, attr in (("unit", "UNIT"), ("layer", "LAYER"), ("moves", "MOVES")):
            if key in entry and getattr(module, attr, None) != entry[key]:
                raise ValueError(
                    f"metrics/{entry['name']}.py: {attr} {getattr(module, attr, None)!r} "
                    f"is not BENCHMARK.json's {entry[key]!r}"
                )
        if cell in entry.get("workloads", [cell]):
            out.append(Metric(entry["name"], entry["unit"], module.read))
    return out

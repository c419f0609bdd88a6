"""The benchmark's instances: a frozen copy of the port's generator.

``kp_lp`` and ``ap_lp`` repeat, draw for draw and character for character,
the arithmetic of ``moip_aira_tpu_torch/utils/generate.py`` as it stood when
the benchmark was defined, so a later change to the port's generator cannot
move the yardstick.  Each returns the LP text that the port's reader reads
and the coefficient arrays that the plain reference (``reference.py``) takes,
so the reference never reads anything the program made.

An instance set is a configuration's list of instances, each drawn from its
own generator seed; the traffic decides in which order a run solves them
(``cycle_orders``)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Instance:
    """One instance: its name, LP text and data.  ``sense`` is "max" or
    "min".  Knapsack: ``values`` (k, n), ``weights`` (n,), ``capacity``.
    Assignment: ``costs`` (k, size, size)."""

    name: str
    family: str
    sense: str
    text: str
    values: np.ndarray | None = None
    weights: np.ndarray | None = None
    capacity: float | None = None
    costs: np.ndarray | None = None


def ap_lp(size: int, objectives: int, seed: int, lo: int = 0, hi: int = 20):
    """k-objective assignment problem (size x size binaries), minimised:
    (text, costs (k, size, size))."""
    rng = np.random.default_rng(seed)
    names = [[f"X{i+1}X{j+1}" for j in range(size)] for i in range(size)]
    lines = [
        "\\ Objective function sense defines the sense of multiple objectives",
        "Minimize 0",
        "s.t.",
        "",
        "\\ Row assignment constraints",
    ]
    for i in range(size):
        lines.append(" + ".join(names[i]) + " = 1")
    lines.append("")
    lines.append("\\ Column assignment constraints")
    for j in range(size):
        lines.append(" + ".join(names[i][j] for i in range(size)) + " = 1")
    lines.append("")
    lines.append("\\ Objectives as the last constraints; last RHS = count")
    costs = []
    for o in range(objectives):
        C = rng.integers(lo, hi, size=(size, size))
        costs.append(C)
        terms = " + ".join(
            f"{C[i][j]} {names[i][j]}" for i in range(size) for j in range(size)
        )
        lines.append(f"{terms} < {o + 1}")
        lines.append("")
    lines.append("BINARY")
    for i in range(size):
        for j in range(size):
            lines.append(names[i][j])
    lines.append("END")
    return "\n".join(lines) + "\n", np.array(costs, dtype=np.int64)


def kp_lp(
    items: int,
    objectives: int,
    seed: int,
    vlo: int = 60,
    vhi: int = 101,
    capacity_frac: float = 0.5,
):
    """k-objective binary knapsack with one capacity row, maximised:
    (text, values (k, n), weights (n,), capacity)."""
    rng = np.random.default_rng(seed)
    names = [f"x{i}" for i in range(items)]
    lines = [
        "\\ Objective function sense defines the sense of multiple objectives",
        "maximize 0",
        "",
        "subject to",
    ]
    w = rng.integers(vlo, vhi, size=items)
    cap = capacity_frac * w.sum()
    lines.append("\\ Capacity constraint 1")
    lines.append(" + ".join(f"{w[i]} {names[i]}" for i in range(items)) + f" <= {cap:g}")
    lines.append("")
    values = []
    for o in range(objectives):
        v = rng.integers(vlo, vhi, size=items)
        values.append(v)
        lines.append("\\ Objective %d" % (o + 1))
        lines.append(" + ".join(f"{v[i]} {names[i]}" for i in range(items)) + f" > {o + 1}")
        lines.append("")
    lines.append("BINARY")
    lines.append(" ".join(names))
    lines.append("END")
    # the text carries the capacity as printed ("%g"), which is what the
    # program reads; the reference takes the same number
    return "\n".join(lines) + "\n", np.array(values, dtype=np.int64), w.astype(np.int64), \
        float(f"{cap:g}")


def make_instance(config: dict, seed: int) -> Instance:
    """The instance of ``config`` drawn from generator seed ``seed``."""
    family, k, size = config["family"], config["objectives"], config["size"]
    gen = config.get("generator", {})
    name = f"{config['name']}-s{seed}"
    if family == "knapsack":
        text, values, weights, cap = kp_lp(size, k, seed, **gen)
        return Instance(name, family, "max", text, values=values, weights=weights,
                        capacity=cap)
    if family == "assignment":
        text, costs = ap_lp(size, k, seed, **gen)
        return Instance(name, family, "min", text, costs=costs)
    raise ValueError(f"unknown instance family {family!r}")


def instance_set(config: dict) -> list:
    """The configuration's instances: ``instances`` of them, from generator
    seeds ``first_seed``, ``first_seed + 1``, ..."""
    first, count = config["first_seed"], config["instances"]
    return [make_instance(config, first + i) for i in range(count)]


def cycle_orders(count: int, seed: int):
    """An endless sequence of cycles, each a permutation of range(count)
    drawn from the run's ``seed``: every cycle solves every instance once."""
    rng = np.random.default_rng(seed)
    while True:
        yield [int(i) for i in rng.permutation(count)]

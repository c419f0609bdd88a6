"""Random instance generators — assignment and knapsack families.

The reference ships pre-generated instances of exactly these two families
(Examples/*.lp: k-objective assignment "kAPnn" and knapsack "kKPnn", per the
papers' experimental setup; the .mop knapsack was produced by Zimpl).  This
module regenerates both families at any size/objective count and writes them
in the same extended-LP convention (objectives as the last ``objcnt``
constraint rows, the last row's RHS giving the count) and in multi-objective
MPS, so the framework is standalone and benchmarks can scale past the
bundled sizes.

Usage:
    python -m moip_aira_tpu_torch.utils.generate ap --size 5 -k 2 --seed 7 -o ap.lp
    python -m moip_aira_tpu_torch.utils.generate kp --items 50 -k 2 --seed 7 -o kp.lp
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np


def ap_lp(size: int, objectives: int, seed: int, lo: int = 0, hi: int = 20) -> str:
    """k-objective assignment problem (size x size binary matrix)."""
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
    for o in range(objectives):
        C = rng.integers(lo, hi, size=(size, size))
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
    return "\n".join(lines) + "\n"


def kp_lp(
    items: int,
    objectives: int,
    seed: int,
    vlo: int = 60,
    vhi: int = 101,
    capacity_frac: float = 0.5,
    constraints: int = 1,
) -> str:
    """k-objective binary knapsack: maximise values under ``constraints``
    capacity rows.  ``constraints=2`` is the paper's KP2D family
    (1701.08920 Timing.ods sheet 2: bi-objective 2-constraint knapsacks;
    weights and values uniform, capacities half the weight sums)."""
    rng = np.random.default_rng(seed)
    names = [f"x{i}" for i in range(items)]
    lines = [
        "\\ Objective function sense defines the sense of multiple objectives",
        "maximize 0",
        "",
        "subject to",
    ]
    for r in range(constraints):
        w = rng.integers(vlo, vhi, size=items)
        cap = capacity_frac * w.sum()
        lines.append("\\ Capacity constraint %d" % (r + 1))
        lines.append(
            " + ".join(f"{w[i]} {names[i]}" for i in range(items))
            + f" <= {cap:g}"
        )
        lines.append("")
    for o in range(objectives):
        v = rng.integers(vlo, vhi, size=items)
        lines.append("\\ Objective %d" % (o + 1))
        lines.append(
            " + ".join(f"{v[i]} {names[i]}" for i in range(items))
            + f" > {o + 1}"
        )
        lines.append("")
    lines.append("BINARY")
    lines.append(" ".join(names))
    lines.append("END")
    return "\n".join(lines) + "\n"


def kp_mop(
    items: int,
    objectives: int,
    seed: int,
    vlo: int = 60,
    vhi: int = 101,
    capacity_frac: float = 0.5,
    integer_ub: Optional[int] = None,
) -> str:
    """Multi-objective MPS knapsack in the reference's .mop convention:
    leading N rows are the (minimised, negated-value) objectives."""
    rng = np.random.default_rng(seed)
    w = rng.integers(vlo, vhi, size=items)
    cap = capacity_frac * w.sum()
    V = rng.integers(vlo, vhi, size=(objectives, items))
    out = ["NAME        generated", "ROWS"]
    out.append(" N  OBJECTIV")
    for o in range(1, objectives):
        out.append(f" N  Cost_{o}")
    out.append(" L  Knapsack")
    out.append("COLUMNS")
    out.append("    MARK0000  'MARKER'                 'INTORG'")
    for i in range(items):
        var = f"x#{i+1}"
        out.append(f"    {var:<9} OBJECTIV  {-int(V[0][i])}")
        out.append(f"    {var:<9} Knapsack  {int(w[i])}")
        for o in range(1, objectives):
            out.append(f"    {var:<9} Cost_{o}  {-int(V[o][i])}")
    out.append("    MARK0001  'MARKER'                 'INTEND'")
    out.append("RHS")
    out.append(f"    RHS       Knapsack  {cap:g}")
    out.append("BOUNDS")
    for i in range(items):
        var = f"x#{i+1}"
        out.append(f" LO BOUND     {var}  0")
        if integer_ub is None:
            out.append(f" PL BOUND     {var}")
        else:
            out.append(f" UP BOUND     {var}  {integer_ub}")
    out.append("ENDATA")
    return "\n".join(out) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="moip-generate")
    sub = ap.add_subparsers(dest="family", required=True)
    pa = sub.add_parser("ap", help="assignment problem (.lp)")
    pa.add_argument("--size", type=int, default=5)
    pk = sub.add_parser("kp", help="binary knapsack (.lp)")
    pk.add_argument("--items", type=int, default=50)
    pk.add_argument(
        "--constraints", type=int, default=1,
        help="capacity rows (2 = the paper's KP2D family)",
    )
    pm = sub.add_parser("mop", help="integer knapsack (.mop)")
    pm.add_argument("--items", type=int, default=30)
    for P in (pa, pk, pm):
        P.add_argument("-k", "--objectives", type=int, default=2)
        P.add_argument("--seed", type=int, default=1)
        P.add_argument("-o", "--output", required=True)
    args = ap.parse_args(argv)
    if args.family == "ap":
        text = ap_lp(args.size, args.objectives, args.seed)
    elif args.family == "kp":
        text = kp_lp(
            args.items, args.objectives, args.seed,
            constraints=args.constraints,
        )
    else:
        text = kp_mop(args.items, args.objectives, args.seed)
    with open(args.output, "w") as fh:
        fh.write(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

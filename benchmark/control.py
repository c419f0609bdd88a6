"""The control of the comparison that decides ``correct``.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 [--cut key=value]

The configuration guarantees the exact nondominated set and states no
floating-point precision: its points are whole numbers.  So the control
breaks a guarantee.  It puts in the program's place the reference's weakly
nondominated set, which is what a front looks like when the lexicographic
stages that break ties are skipped, the step that would tempt a faster
backend.  For each seed it takes the fronts of the shortest window a run
can have (one cycle of the cell's instance set, in the seed's order),
compares them with ``judge.compare`` as ``run.py`` does, and prints the
numbers compared and whether the run would count as correct.  The
benchmark's own runs do not run it."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import instances  # noqa: E402
import judge  # noqa: E402
import reference  # noqa: E402
import registry  # noqa: E402
from run import parse_cut  # noqa: E402


def readings(config: dict, seeds) -> list:
    """[(seed, checks, correct)] with the control in the program's place."""
    insts = instances.instance_set(config)
    strict = [reference.front(i) for i in insts]
    weak = [reference.front(i, weak=True) for i in insts]
    out = []
    for seed in seeds:
        order = next(instances.cycle_orders(len(insts), seed))
        checks, _ = judge.compare([(i, weak[i]) for i in order], dict(enumerate(strict)))
        out.append((seed, checks, judge.passes(checks)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--cut", action="append", metavar="KEY=VALUE")
    args = ap.parse_args(argv)
    cell = registry.find_cell(args.workload)
    config = {**cell.config, **parse_cut(args.cut)}
    for seed, checks, correct in readings(config, args.seeds):
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": correct,
                          "checks": checks}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""`aira`-compatible command line driver of the port.

The flags of ``moip_aira_tpu/cli.py`` (``-p/--lp``, ``-o/--output``,
``-t/--threads``, ``-c/--cplex_threads``, ``-s/--spread``, ``--split``,
``--split-normal``, ``--backend``, ``--mesh``, ``--dp``, ``--sweep``,
``--stats``) plus ``--device {cuda,cpu}``, which says where the wave
backend's LPs run (default cuda; there is no fallback to the CPU).  The
``.out`` file is written by the byte-equal writer (``io/writer.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from moip_aira_tpu_torch import __version__
from moip_aira_tpu_torch.api import solve_front
from moip_aira_tpu_torch.io import read_problem
from moip_aira_tpu_torch.io.writer import write_out


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="aira-torch",
        description="Exact multi-objective integer programming on a GPU "
        "(AIRA algorithm with synergistic / EPP parallel decompositions)",
    )
    ap.add_argument("-p", "--lp", dest="problem", required=True,
                    help="The LP/MOP file to solve. Required.")
    ap.add_argument("-o", "--output", dest="output", default=None,
                    help="The output file. Optional (defaults to <problem>.out).")
    ap.add_argument("--split", action="store_true", default=False,
                    help="Split the range of the last objective into one strip "
                         "per worker (EPP).")
    ap.add_argument("--split-normal", dest="split_normal", action="store_true",
                    default=False,
                    help="If splitting, assume normally distributed objective "
                         "values (max 12 workers).")
    ap.add_argument("-s", "--spread", dest="spread", nargs="?", const="1",
                    default="1", metavar="0|1",
                    help="Spread workers over subgroups of the objective "
                         "orderings (default). --spread=0 clusters workers "
                         "inside subgroups instead.")
    ap.add_argument("-t", "--threads", dest="threads", type=int, default=1,
                    help="Number of AIRA workers (batched per device).")
    ap.add_argument("-c", "--cplex_threads", dest="solver_threads", type=int,
                    default=1,
                    help="Accepted for aira compatibility; the native backend "
                         "batches branch-and-bound nodes instead.")
    ap.add_argument("--backend",
                    choices=("auto", "jax", "wave", "numpy", "kpbb", "apbb"),
                    default="auto",
                    help="Solve kernel backend (kpbb/apbb = combinatorial "
                    "knapsack/assignment engines; auto routes each detected "
                    "family there; jax is not ported yet).")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="Where the wave backend's LP relaxations run "
                         "(default cuda).")
    ap.add_argument("--mesh", dest="mesh", type=int, default=None,
                    help="Shard solve batches over an N-device mesh (not "
                         "ported yet).")
    ap.add_argument("--dp", choices=("auto", "off"), default="auto",
                    help="Knapsack front DP (not ported yet: both values take "
                         "the general AIRA engine).")
    ap.add_argument("--sweep", choices=("auto", "on", "off"), default="auto",
                    help="Adaptive parallel bound sweep for bi-objective "
                         "fronts (default auto: on for the wave backend; off "
                         "forces the AIRA ladder).")
    ap.add_argument("--stats", action="store_true", default=False,
                    help="Print scheduler/backend statistics to stderr.")
    ap.add_argument("--version", action="version",
                    version=f"moip-aira-tpu-torch {__version__}")
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    problem = read_problem(args.problem)
    out_path = args.output
    if out_path is None:
        base, _ = os.path.splitext(args.problem)
        out_path = base + ".out"

    try:
        front = solve_front(
            problem,
            n_workers=args.threads,
            spread=(args.spread != "0"),
            split=args.split,
            split_normal=args.split_normal,
            backend=args.backend,
            device=args.device,
            mesh_devices=args.mesh,
            solver_threads=args.solver_threads,
            dp=args.dp,
            sweep=args.sweep,
        )
    except (ValueError, NotImplementedError) as e:
        sys.stderr.write(f"Error: {e}\n")
        return 1

    with open(out_path, "w") as fh:
        write_out(fh, front, version_tag=__version__)
    if args.stats:
        bs = front.batch_sizes or []
        sys.stderr.write(
            f"[stats] rounds={front.rounds} ip_solves={front.ip_count} "
            f"mean_batch={np.mean(bs) if bs else 0.0:.1f} "
            f"max_batch={max(bs) if bs else 0} "
            f"cpu={front.cpu_seconds:.3f}s wall={front.elapsed_seconds:.3f}s\n"
        )
        sys.stderr.write(f"[stats] {json.dumps(front.backend_stats)}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

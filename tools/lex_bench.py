#!/usr/bin/env python3
"""Time the port's lex backend (``backend="jax"``: solver/lex_torch.py, on
the card K6, one launch a batch) on the card.

For each front (G2AP05 on the bound sweep, G3AP05 and G3KP10 on the AIRA
scheduler, ``n_workers=2``) it prints one JSON line with the seconds to the
front, IPs, rounds, the lex counters (batches, lanes, fallbacks, the lanes'
B&B nodes and LP steps and the largest lane's of each batch, summed, host
syncs), K6's launches and microseconds a node, then the same front on the
wave (K1) for comparison.  ``--batch`` adds one call of the lex kernel on
the smoke's batch (``chip_smoke.LEX_BATCH``: 2AP20's 32 lanes, the initial
rhs and golden points under both orderings), timed on the card and, with
``--cpu``, on the CPU.  ``--cpu-fronts`` runs the fronts on the CPU alone
(K6's plain version) and prints the same counters: the IPs and the nodes
and LP steps over all lanes that the smoke holds the card to
(``chip_smoke.LEX_FRONTS``); it needs no card.

    python3 tools/lex_bench.py [--fronts G2AP05,G3AP05,G3KP10] [--batch] [--cpu]
    python3 tools/lex_bench.py --cpu-fronts
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
EXAMPLES = os.path.join(REPO, "examples")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fronts", default="G2AP05,G3AP05,G3KP10")
    ap.add_argument("--batch", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--no-wave", action="store_true")
    ap.add_argument("--cpu-fronts", action="store_true",
                    help="the fronts on the CPU alone, no card")
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as smoke
    from moip_aira_tpu_torch.api import solve_front
    from moip_aira_tpu_torch.io import read_problem
    from moip_aira_tpu_torch.solver.lex_torch import TorchLexBackend, make_lex_kernel

    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    dev = "cpu" if args.cpu_fronts else "cuda"
    if dev == "cuda" and not torch.cuda.is_available():
        raise SystemExit("lex_bench: no card (torch.cuda.is_available() is False)")
    card = "cpu" if dev == "cpu" else smoke.card()
    print(json.dumps({"card": card, "torch": torch.__version__}), flush=True)
    if dev == "cuda":
        from moip_aira_tpu_torch.kernels.build import load

        load("lex_bnb")  # K6 built before the fronts are timed, and K5,
        load("simplex_dense")  # whose library reads the card's limits
        if not args.no_wave:
            load("dense_simplex")  # and K1 before the wave is

    for name in [n for n in args.fronts.split(",") if n]:
        p = read_problem(os.path.join(EXAMPLES, f"{name}.lp"))
        be = TorchLexBackend(p, device=dev)
        sync()
        t0 = time.perf_counter()
        f = solve_front(p, n_workers=2, backend=be, device=dev, dp="off")
        sync()
        sec = time.perf_counter() - t0
        row = {
            "front": name, "backend": "jax", "seconds": sec,
            "golden": bool(np.array_equal(f.points, smoke.golden_front(name))),
            "ips": f.ip_count, "rounds": f.rounds,
            # bnb_steps and lp_steps: the plain loop's only, on the CPU
            **{k: f.backend_stats.get(k) for k in (
                "device_batches", "lanes", "fallback_count", "nodes", "iters",
                "path_nodes", "path_iters", "bnb_steps", "lp_steps", "host_syncs",
                "kernel_launches")},
            "us_per_node": sec / max(1, be.nodes) * 1e6,
            "device": dev, "torch": torch.__version__, "card": card,
        }
        print(json.dumps(row), flush=True)
        if args.no_wave or dev == "cpu":
            continue
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f = solve_front(p, n_workers=2, backend="wave", device="cuda", dp="off")
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        print(json.dumps({
            "front": name, "backend": "wave", "seconds": sec,
            "golden": bool(np.array_equal(f.points, smoke.golden_front(name))),
            "ips": f.ip_count, "rounds": f.rounds,
            "device_waves": f.backend_stats["device_waves"],
            "lp_count": f.backend_stats["lp_count"], "card": card,
        }), flush=True)

    if args.batch and dev == "cuda":
        name, lanes = smoke.LEX_BATCH
        p = read_problem(os.path.join(EXAMPLES, f"{name}.lp"))
        rhs, perm = smoke.lex_batch(p, lanes)
        devs = ["cuda"] + (["cpu"] if args.cpu else [])
        outs = {}
        for dev in devs:
            kern = make_lex_kernel(p, device=dev)
            if dev == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = [t.cpu().numpy() for t in kern(rhs, perm)]
            sec = time.perf_counter() - t0
            outs[dev] = out
            print(json.dumps({
                "batch": name, "device": dev, "lanes": len(rhs), "seconds": sec,
                "status": np.bincount(out[0], minlength=4).tolist(),
                "nodes": kern.nodes, "iters": kern.iters, "path_nodes": kern.path_nodes,
                "path_iters": kern.path_iters, "launches": kern.launches,
                "bnb_steps": getattr(kern, "bnb_steps", None),
                "lp_steps": getattr(kern, "lp_steps", None),
                "us_per_node": sec / max(1, kern.nodes) * 1e6,
                "card": card,
            }), flush=True)
        if "cpu" in outs:
            same = all(np.array_equal(a, b) for a, b in zip(outs["cuda"], outs["cpu"]))
            print(json.dumps({"batch": name, "cuda_equals_cpu": same}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

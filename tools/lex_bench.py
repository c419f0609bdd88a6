#!/usr/bin/env python3
"""Time the port's lex backend (``backend="jax"``: solver/lex_torch.py on
the dense simplex of solver/simplex_dense.py) on the card.

For each front (G2AP05 on the bound sweep, G3AP05 and G3KP10 on the AIRA
scheduler, ``n_workers=2``) it prints one JSON line with the seconds to the
front, IPs, rounds, the lex counters (batches, lanes, fallbacks, B&B steps,
LP steps, host syncs) and microseconds a step, then the same front on the
wave (K1) for comparison.  ``--batch`` adds one call of the lex kernel on
the smoke's batch (``chip_smoke.LEX_BATCH``: 2AP20's 32 lanes, the initial
rhs and golden points under both orderings),
timed on the card and, with ``--cpu``, on the CPU.  ``--eager`` launches
each LP step's kernels one by one instead of as the solver's CUDA graph.

    python3 tools/lex_bench.py [--fronts G2AP05,G3AP05,G3KP10] [--batch] [--cpu]
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
    ap.add_argument("--eager", action="store_true",
                    help="launch a step's kernels one by one (no CUDA graph)")
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as smoke
    from moip_aira_tpu_torch.api import solve_front
    from moip_aira_tpu_torch.io import read_problem
    from moip_aira_tpu_torch.solver.lex_torch import TorchLexBackend, make_lex_kernel

    if not torch.cuda.is_available():
        raise SystemExit("lex_bench: no card (torch.cuda.is_available() is False)")
    if args.eager:
        from moip_aira_tpu_torch.solver.simplex_dense import DenseLPSolver

        def eager(self, c, lo, hi, active):
            S = self._start(c, lo, hi, active)
            return S, lambda: self._step(S)

        DenseLPSolver._graphed = eager
    mode = "eager" if args.eager else "graph"
    card = smoke.card()
    print(json.dumps({"card": card, "torch": torch.__version__}), flush=True)
    if not args.no_wave:
        from moip_aira_tpu_torch.kernels.build import load

        load("dense_simplex")  # K1 built before the wave is timed

    for name in [n for n in args.fronts.split(",") if n]:
        p = read_problem(os.path.join(EXAMPLES, f"{name}.lp"))
        be = TorchLexBackend(p, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f = solve_front(p, n_workers=2, backend=be, device="cuda", dp="off")
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        row = {
            "front": name, "backend": "jax", "seconds": sec,
            "golden": bool(np.array_equal(f.points, smoke.golden_front(name))),
            "ips": f.ip_count, "rounds": f.rounds,
            **{k: f.backend_stats[k] for k in (
                "device_batches", "lanes", "fallback_count",
                "bnb_steps", "lp_steps", "host_syncs")},
            "us_per_lp_step": sec / max(1, be.lp_steps) * 1e6,
            "mode": mode, "card": card,
        }
        print(json.dumps(row), flush=True)
        if args.no_wave:
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

    if args.batch:
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
                "bnb_steps": kern.bnb_steps, "lp_steps": kern.lp_steps,
                "host_syncs": kern.host_syncs,
                "us_per_lp_step": sec / max(1, kern.lp_steps) * 1e6,
                "mode": mode, "card": card,
            }), flush=True)
        if "cpu" in outs:
            same = all(np.array_equal(a, b) for a, b in zip(outs["cuda"], outs["cpu"]))
            print(json.dumps({"batch": name, "cuda_equals_cpu": same}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

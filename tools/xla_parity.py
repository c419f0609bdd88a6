#!/usr/bin/env python3
"""The wave's XLA engine (solver/xla_lp.py) on the card, K5, against the
same engine on the CPU, its plain version.

Runs one front (``--front``, default G2AP05) through solve_front on both
devices at the smoke's widths (``batch_width=2048``, ``nodes_per_task=32``),
records every wave's inputs and the outputs the wave reads (status, basis,
at-upper flags), and prints the counts of both runs (IPs, waves, LPs,
re-solves, LP steps).  Then it holds K5's outputs against the CPU's wave
by wave and lane by lane; at the first wave that differs it solves that
wave's inputs on both devices again and prints each differing lane with the
outputs (status, obj, x, basis, at_upper, iters) that differ.

``--cpu-counts`` runs the smoke's XLA fronts (``chip_smoke.XLA_FRONTS``) on
the CPU alone and prints their counts (``chip_smoke.XLA_CPU_COUNTS``); it
needs no card.

    python3 tools/xla_parity.py [--front G2AP05] [--dtype float32] [--workers 2]
    python3 tools/xla_parity.py --cpu-counts
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def run_front(p, dev, dtype, workers=2):
    """The front's counts on ``dev`` and each wave's (inputs, outputs)."""
    from moip_aira_tpu_torch.api import solve_front
    from moip_aira_tpu_torch.solver.wave import WaveLexBackend

    be = WaveLexBackend(
        p, device=dev, engine="xla", dtype=dtype, fragments=False, batch_width=2048,
        nodes_per_task=32,
    )
    log = []
    real = be._device_lp

    def spy(c, lo, hi, wb, wa):
        out = real(c, lo, hi, wb, wa)
        for ev in out[3]:
            ev.synchronize()
        log.append(((c.copy(), lo.copy(), hi.copy()), [t.numpy().copy() for t in out[:3]]))
        return out

    be._device_lp = spy
    front = solve_front(p, n_workers=workers, backend=be, device=dev, dp="off")
    counts = {"ips": front.ip_count, "waves": be.device_waves, "lps": be.lp_count,
              "verify_fallbacks": be.verify_fallbacks, "lp_steps": be.lp_kernel.steps,
              "launches": be.lp_kernel.launches}
    return counts, log


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--front", default="G2AP05")
    ap.add_argument("--dtype", default="float32", choices=("float32", "float64"))
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--cpu-counts", action="store_true",
                    help="the smoke's XLA fronts on the CPU alone")
    args = ap.parse_args()

    import numpy as np
    import torch

    from moip_aira_tpu_torch.convert import lp_tensors
    from moip_aira_tpu_torch.io import read_problem
    from moip_aira_tpu_torch.solver.xla_lp import XlaLPBatch

    if args.cpu_counts:
        import chip_smoke

        for name, dtype, workers, _ in chip_smoke.XLA_FRONTS:
            p = read_problem(os.path.join(REPO, "examples", f"{name}.lp"))
            counts, _ = run_front(p, "cpu", dtype, workers)
            print(json.dumps({"front": name, "dtype": dtype, "workers": workers,
                              "device": "cpu", "torch": torch.__version__, **counts}), flush=True)
        return 0
    if not torch.cuda.is_available():
        raise SystemExit("xla_parity: no card (torch.cuda.is_available() is False)")
    p = read_problem(os.path.join(REPO, "examples", f"{args.front}.lp"))
    W = lp_tensors(p, "cpu").W_np
    counts, logs = {}, {}
    for dev in ("cuda", "cpu"):
        counts[dev], logs[dev] = run_front(p, dev, args.dtype, args.workers)
    print(json.dumps({"front": args.front, "dtype": args.dtype, "counts": counts}), flush=True)
    for w, ((inp, out_card), (inp_cpu, out_cpu)) in enumerate(zip(logs["cuda"], logs["cpu"])):
        if not all(np.array_equal(a, b) for a, b in zip(inp, inp_cpu)):
            print(json.dumps({"wave": w, "inputs_differ": True}))
            return 1
        lanes = [i for i in range(len(inp[0]))
                 if not all(np.array_equal(a[i], b[i]) for a, b in zip(out_card, out_cpu))]
        if not lanes:
            continue
        # the wave again on both devices, every output of every lane
        outs = {}
        for dev in ("cuda", "cpu"):
            eng = XlaLPBatch(W, dev, dtype=args.dtype)
            t = [torch.as_tensor(a, dtype=eng.dtype, device=dev) for a in inp]
            outs[dev] = {f: v.cpu().numpy() for f, v in eng(*t)._asdict().items()}
        diff = {
            i: [f for f in outs["cpu"] if not np.array_equal(outs["cuda"][f][i], outs["cpu"][f][i])]
            for i in range(len(inp[0]))
        }
        print(json.dumps({
            "wave": w, "lanes": len(inp[0]), "differing_lanes": lanes,
            "replayed": {str(i): f for i, f in diff.items() if f},
        }), flush=True)
        return 1
    print(json.dumps({"waves_equal": len(logs["cuda"]), "lanes_equal": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

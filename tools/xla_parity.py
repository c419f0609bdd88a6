#!/usr/bin/env python3
"""Where the wave's XLA engine on the card parts from the same engine on
the CPU (solver/xla_lp.py, float32).

Runs one front (``--front``, default G2AP05) through solve_front on both
devices at the smoke's widths, records every wave's inputs and outputs,
and prints the counts of both runs.  At the first wave whose outputs
differ it steps the first differing lane on both devices in lock step and
prints the first step, and the state, where they part; then it replays
that lane on the CPU with the tableau update's product rounded before it
is subtracted (what the card's ``addcmul`` computes) and says whether that
replay gives the card's basis.

``--dtype float64`` prints the counts only.

    python3 tools/xla_parity.py [--front G2AP05] [--dtype float32]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def run_front(p, dev, dtype):
    """The front on ``dev`` and each wave's (inputs, outputs)."""
    from moip_aira_tpu_torch.api import solve_front
    from moip_aira_tpu_torch.solver.wave import WaveLexBackend

    be = WaveLexBackend(
        p, device=dev, engine="xla", dtype=dtype, batch_width=2048, nodes_per_task=32
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
    front = solve_front(p, n_workers=2, backend=be, device=dev, dp="off")
    counts = {"ips": front.ip_count, "waves": be.device_waves, "lps": be.lp_count,
              "verify_fallbacks": be.verify_fallbacks, "steps": be.lp_kernel.steps}
    return counts, log


def solve(W, lane, dev, rounded_update=False):
    """One lane on ``dev``; with ``rounded_update`` the tableau update
    subtracts the rounded product (CPU only)."""
    import torch

    from moip_aira_tpu_torch.solver.simplex_dense import DenseLPSolver
    from moip_aira_tpu_torch.solver.xla_lp import F32_TOLERANCES

    solver = DenseLPSolver(torch.as_tensor(W, dtype=torch.float32, device=dev), 2000, **F32_TOLERANCES)
    args = [torch.as_tensor(a, dtype=torch.float32, device=dev) for a in lane]
    if not rounded_update:
        return solver, solver._start(*args, None)
    real = torch.Tensor.addcmul_
    torch.Tensor.addcmul_ = lambda t, a, b, value=1.0: t.add_(value * (a * b))
    try:
        out = solver(*args)
    finally:
        torch.Tensor.addcmul_ = real
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--front", default="G2AP05")
    ap.add_argument("--dtype", default="float32", choices=("float32", "float64"))
    args = ap.parse_args()

    import numpy as np
    import torch

    from moip_aira_tpu_torch.convert import lp_tensors
    from moip_aira_tpu_torch.io import read_problem

    if not torch.cuda.is_available():
        raise SystemExit("xla_parity: no card (torch.cuda.is_available() is False)")
    p = read_problem(os.path.join(REPO, "examples", f"{args.front}.lp"))
    W = lp_tensors(p, "cpu").W_np
    counts, logs = {}, {}
    for dev in ("cuda", "cpu"):
        counts[dev], logs[dev] = run_front(p, dev, args.dtype)
    print(json.dumps({"front": args.front, "dtype": args.dtype, "counts": counts}), flush=True)
    if args.dtype == "float64":
        return 0
    for w, ((inp, out_card), (inp_cpu, out_cpu)) in enumerate(zip(logs["cuda"], logs["cpu"])):
        if not all(np.array_equal(a, b) for a, b in zip(inp, inp_cpu)):
            print(json.dumps({"wave": w, "inputs_differ": True}))
            return 0
        lanes = [i for i in range(len(inp[0]))
                 if not all(np.array_equal(a[i], b[i]) for a, b in zip(out_card, out_cpu))]
        if not lanes:
            continue
        i = lanes[0]
        lane = [a[i:i + 1] for a in inp]
        (s_card, S_card), (s_cpu, S_cpu) = solve(W, lane, "cuda"), solve(W, lane, "cpu")
        parted = None
        for k in range(1, 2001):
            s_card._step(S_card)
            s_cpu._step(S_cpu)
            diff = [f for f, v in vars(S_cpu).items() if isinstance(v, torch.Tensor)
                    and not torch.equal(getattr(S_card, f).cpu(), v)]
            if diff:
                parted = {"step": k, "state": diff}
                break
            if not bool(S_cpu.any_run):
                break
        replay = solve(W, lane, "cpu", rounded_update=True)
        card_basis = out_card[1][i].tolist()
        print(json.dumps({
            "wave": w, "lanes": len(inp[0]), "differing_lanes": lanes, "lane": i,
            "card_basis": card_basis, "cpu_basis": out_cpu[1][i].tolist(),
            "parted": parted,
            "replay_with_rounded_update_gives_card_basis": replay.basis[0].tolist() == card_basis,
        }), flush=True)
        return 0
    print(json.dumps({"waves_equal": len(logs["cuda"])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

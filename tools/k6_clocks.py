#!/usr/bin/env python3
"""K6's regs shape, its cycles split by part, on the card.

Launches a variant of K6 built with ``-DK6_CLOCKS`` (beside the production
build, which is unchanged) on chip_smoke.py's lex batch of the fronts'
shape on the regs plan (``cuda_lex.regs_plan``): G3KP10 at 32 lanes.  The
first thread of each lane counts the SM cycles of each part of its run
(PARTS, in the kernel's order: a node's start and its basic values; per
LP step pricing, the column arg-max, the winner's values, the objective's
nonbasic sum, the ratio test with its minimum, the row pick, the outcome, the basic values'
step with the rank-1 update, the next step's row sums; a node's finish and
its B&B part).  Prints, after the card's name and power limit, one JSON
line a batch: the parts' cycles a step (their sums over the lanes over the
lanes' LP steps) and the node parts' cycles a node.  The clock reads order
the code around them, so the parts add up to more than a production step
and no part overlaps another.  Run from the root of a checkout:

    python3 tools/k6_clocks.py
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

#: the parts of a regs lane's run in a -DK6_CLOCKS build, in the kernel's order
PARTS = ("start", "xb_start", "pricing", "col_argmax", "winner", "czv", "ratio_min",
         "row_pick", "outcome", "xb_rank1", "row_sums", "finish", "bnb")
#: the parts a node runs once
NODE_PARTS = ("start", "xb_start", "finish", "bnb")
BATCHES = (("G3KP10", 32),)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k6_clocks: torch.cuda.is_available() is False")
    import chip_smoke as smoke
    from moip_aira_tpu_torch.io import read_problem
    from moip_aira_tpu_torch.solver import cuda_lex
    from moip_aira_tpu_torch.solver.lex_torch import make_lex_kernel

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)
    defines = ("-DK6_CLOCKS",)
    lib = cuda_lex._lib(defines)
    lib.lex_bnb_set_clocks.argtypes = [ctypes.c_void_p]
    lib.lex_bnb_set_clocks.restype = ctypes.c_int
    for name, lanes in BATCHES:
        p = read_problem(os.path.join(smoke.EXAMPLES, f"{name}.lp"))
        rhs, perm = smoke.lex_batch(p, lanes)
        lp = make_lex_kernel(p, device="cpu").lp  # K6 runs the plain loop's LP defaults
        kern = make_lex_kernel(p, device="cuda")
        buf = torch.zeros((lanes, len(PARTS)), dtype=torch.int64, device="cuda")
        if lib.lex_bnb_set_clocks(buf.data_ptr()) != 0:
            raise RuntimeError("lex_bnb_set_clocks failed")
        out = cuda_lex.launch_lex_bnb(
            kern.W, torch.as_tensor(rhs, device="cuda"), torch.as_tensor(perm, device="cuda"),
            kern.C, kern.lb, kern.ub, kern.row_lb, kern.row_ub, kern.is_int,
            kern.obj_integral, kern.is_min, kern.maxn, kern.max_bnb_nodes, lp.max_iters,
            lp.feas_tol, lp.cost_tol, lp.pivot_tol, lp.progress_tol, lp.stall_limit,
            plan=cuda_lex.regs_plan(p.m_total, p.n), defines=defines,
        )
        torch.cuda.synchronize()
        lib.lex_bnb_set_clocks(None)
        cyc = buf.cpu().numpy().astype(np.float64).sum(0)
        steps, nodes = float(out.iters.sum()), float(out.nodes.sum())
        print(json.dumps({
            "instance": name, "lanes": lanes, "m": p.m_total, "nc": p.n + p.m_total,
            "steps": steps, "nodes": nodes,
            "cycles_a_step": {k: round(v / steps, 1) for k, v in zip(PARTS, cyc)
                              if k not in NODE_PARTS},
            "node_cycles_a_node": {k: round(v / nodes, 1) for k, v in zip(PARTS, cyc)
                                   if k in NODE_PARTS},
            "all_cycles_a_step": round(cyc.sum() / steps, 1),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

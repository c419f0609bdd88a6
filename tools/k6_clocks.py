#!/usr/bin/env python3
"""K6's own shapes, their cycles split by part, and K6's plans timed, on the
card.

For each batch of BATCHES (chip_smoke.py's lex batches: G3KP10 at 32 lanes,
whose 4 x 14 LPs take the ``regs`` shape; G2AP05 and G3AP05 at 32, whose
12 x 37 and 13 x 38 LPs take ``regs_block``; 3AP10 at 18, ``ap_case``,
whose 23 x 123 LPs take ``regs_block``), prints after the card's name and
power limit:

* ``plans``: K6 on the batch in every plan that fits (``cuda_lex.lex_plans``:
  a warp a lane at P = 1, 2, 4 and 8, a block, and K6's own shape), ms
  (CUDA events, median of 5) and us a critical-path step (ms over the
  largest lane's LP steps); fails unless every plan's outputs equal
  ``packed``'s;
* ``clocks``: a variant of K6 built with ``-DK6_CLOCKS`` (beside the
  production build, which is unchanged) on the batch's own shape.  The
  first thread of each lane counts the SM cycles of each part of its run
  (PARTS, in the regs kernel's order: a node's start and its basic values;
  per LP step pricing, the column arg-max, the winner's values (on
  regs_block: the step's block barrier and the read of the winners), the
  objective's nonbasic sum, the ratio test with its minimum, the row pick,
  the outcome, the basic values' step with the rank-1 update, the next
  step's row sums; a node's finish and its B&B part): the parts' cycles a
  step (their sums over the lanes over the lanes' LP steps) and the node
  parts' cycles a node.  The clock reads order the code around them, so
  the parts add up to more than a production step and no part overlaps
  another;
* ``packed_clocks`` (3AP10): K5's loop, the one K6's ``packed`` shape runs
  at every node, built with ``-DK5_CLOCKS`` and launched on the batch's
  root LPs on K5's ``packed`` plan (four lanes a block): its cycles a step
  by K5's parts (tools/k5_bench.py's PARTS), the split a ``packed`` step of
  23 x 123 takes.

Run from the root of a checkout:

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

#: the parts of a regs or regs_block lane's run in a -DK6_CLOCKS build, in
#: the regs kernel's order
PARTS = ("start", "xb_start", "pricing", "col_argmax", "winner", "czv", "ratio_min",
         "row_pick", "outcome", "xb_rank1", "row_sums", "finish", "bnb")
#: the parts a node runs once
NODE_PARTS = ("start", "xb_start", "finish", "bnb")
#: the parts of K5's loop in a -DK5_CLOCKS build (tools/k5_bench.py's)
K5_PARTS = ("start", "row_sums", "phase_test", "pricing", "czv", "ratio_test",
            "row_pick", "outcome", "xb_step", "rank1", "barriers")
#: (instance, lanes, K6's own shape there)
BATCHES = (("G3KP10", 32, "regs"), ("G2AP05", 32, "regs_block"), ("G3AP05", 32, "regs_block"),
           ("3AP10", 18, "regs_block"))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k6_clocks: torch.cuda.is_available() is False")
    import chip_smoke as smoke
    from moip_aira_tpu_torch.io import read_problem
    from moip_aira_tpu_torch.solver import cuda_dense, cuda_lex
    from moip_aira_tpu_torch.solver.lex_torch import make_lex_kernel

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)
    defines = ("-DK6_CLOCKS",)
    lib = cuda_lex._lib(defines)
    lib.lex_bnb_set_clocks.argtypes = [ctypes.c_void_p]
    lib.lex_bnb_set_clocks.restype = ctypes.c_int
    for name, lanes, shape in BATCHES:
        if name == smoke.LEX_AP_BATCH[0]:
            p, rhs, perm = smoke.ap_case(lanes)
        else:
            p = read_problem(os.path.join(smoke.EXAMPLES, f"{name}.lp"))
            rhs, perm = smoke.lex_batch(p, lanes)
        lp = make_lex_kernel(p, device="cpu").lp  # K6 runs the plain loop's LP defaults
        kern = make_lex_kernel(p, device="cuda")
        args = [torch.as_tensor(rhs, device="cuda"), torch.as_tensor(perm, device="cuda")]

        def launch(plan, defines=()):
            return cuda_lex.launch_lex_bnb(
                kern.W, *args, kern.C, kern.lb, kern.ub, kern.row_lb, kern.row_ub, kern.is_int,
                kern.obj_integral, kern.is_min, kern.maxn, kern.max_bnb_nodes, lp.max_iters,
                lp.feas_tol, lp.cost_tol, lp.pivot_tol, lp.progress_tol, lp.stall_limit,
                plan=plan, defines=defines,
            )

        plans = cuda_lex.lex_plans(kern.W)
        own = next(q for q in plans if q.shape == shape and q.P in (1, cuda_dense.K5_PACK_LANES))
        ref = next(q for q in plans if q.shape == "packed")  # K5's loop, in K6
        want = [t.cpu().numpy() for t in launch(ref)]
        path = int(want[4].max())
        differ = []
        for plan in plans:
            got = [t.cpu().numpy() for t in launch(plan)]
            equal = all(np.array_equal(a, b) for a, b in zip(got, want))
            differ += [] if equal else [plan]
            ms = smoke.cuda_ms(lambda plan=plan: launch(plan))
            print(json.dumps({
                "kind": "plans", "instance": name, "lanes": lanes, "m": p.m_total,
                "nc": p.n + p.m_total, "shape": plan.shape, "P": plan.P,
                "threads": plan.threads, "ms": ms, "path_steps": path,
                "us_per_path_step": 1e3 * ms / path, "nodes": int(want[3].sum()),
                "steps": int(want[4].sum()), "equal_to_packed": equal,
                "status_counts": np.bincount(want[0], minlength=5).tolist(),
            }), flush=True)
        if differ:
            raise AssertionError(f"{name}: {differ} differ from {ref}")

        buf = torch.zeros((lanes, len(PARTS)), dtype=torch.int64, device="cuda")
        if lib.lex_bnb_set_clocks(buf.data_ptr()) != 0:
            raise RuntimeError("lex_bnb_set_clocks failed")
        out = launch(own, defines)
        torch.cuda.synchronize()
        lib.lex_bnb_set_clocks(None)
        cyc = buf.cpu().numpy().astype(np.float64).sum(0)
        steps, nodes = float(out.iters.sum()), float(out.nodes.sum())
        print(json.dumps({
            "kind": "clocks", "instance": name, "shape": shape, "lanes": lanes,
            "m": p.m_total, "nc": p.n + p.m_total, "steps": steps, "nodes": nodes,
            "cycles_a_step": {k: round(v / steps, 1) for k, v in zip(PARTS, cyc)
                              if k not in NODE_PARTS},
            "node_cycles_a_node": {k: round(v / nodes, 1) for k, v in zip(PARTS, cyc)
                                   if k in NODE_PARTS},
            "all_cycles_a_step": round(cyc.sum() / steps, 1),
        }), flush=True)

        if name == smoke.LEX_AP_BATCH[0]:
            k5_defines = ("-DK5_CLOCKS",)
            k5 = cuda_dense._lib(k5_defines)
            k5.simplex_dense_set_clocks.argtypes = [ctypes.c_void_p]
            k5.simplex_dense_set_clocks.restype = ctypes.c_int
            roots = [torch.as_tensor(a, dtype=torch.float64, device="cuda")
                     for a in smoke.lex_root_lanes(p, rhs, perm)]
            plan = cuda_dense.loop_plan_for(p.m_total, p.n + p.m_total, torch.float64,
                                            "packed", 1, cuda_dense.device_limits(0)[0])
            kbuf = torch.zeros((lanes, len(K5_PARTS)), dtype=torch.int64, device="cuda")
            if k5.simplex_dense_set_clocks(kbuf.data_ptr()) != 0:
                raise RuntimeError("simplex_dense_set_clocks failed")
            res = cuda_dense.launch_dense_loop(
                kern.W, *roots, None, lp.max_iters, lp.feas_tol, lp.cost_tol, lp.pivot_tol,
                lp.progress_tol, lp.stall_limit, plan=plan, defines=k5_defines,
            )
            torch.cuda.synchronize()
            k5.simplex_dense_set_clocks(None)
            kc = kbuf.cpu().numpy().astype(np.float64).sum(0)
            ksteps = float(res.iters.sum())
            print(json.dumps({
                "kind": "packed_clocks", "instance": name, "lanes": lanes, "P": plan.P,
                "steps": ksteps, "max_iters": int(res.iters.max()),
                "cycles_a_step": {k: round(v / ksteps, 1) for k, v in
                                  zip(K5_PARTS[1:], kc[1:])},
                "start_cycles_a_lane": round(kc[0] / lanes, 1),
                "all_step_cycles_a_step": round(kc[1:].sum() / ksteps, 1),
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

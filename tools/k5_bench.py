#!/usr/bin/env python3
"""K5, the dense simplex loop, timed on the card.

Times K5 (``csrc/simplex_dense.cu`` through ``solver/cuda_dense.py``) on
lanes made as chip_smoke.py's phase ``dense-loop`` makes them (its seeds)
and prints one JSON line per row, after the card's name and power limit:

* ``fronts`` (``--fronts``, run first): the fronts K5's loop serves, each
  run twice (a timed run, then one under torch.profiler): the wave's XLA
  engine on G2AP05, G3KP10 and 2AP20 in float32 and G3AP05 in float64
  (chip_smoke.py's XLA_FRONTS, its widths), the lex backend on G2AP05,
  G3AP05 and G3KP10 (LEX_FRONTS, ``n_workers=2``) and one lex kernel call
  on 2AP20's 32 lanes (LEX_BATCH): seconds, IPs, waves or batches, LP
  steps (the lockstep steps of a checkout whose lex B&B runs from the host,
  else the lanes' nodes and LP steps), the launches of K5 and of K6 (the
  lex backend's batch in one kernel, where the checkout has it; by shape, C
  and P where the checkout counts them), the mean lanes a launch and each
  kernel's device time over the front;
* ``k5``: K5 with the launch its wrapper picks at phase ``dense-loop``'s
  rows (G3KP10, KP2D50 and G2AP05 on 64 lanes, 2AP20 on 32, 2AP40 on
  256 and 2AP60 on 8, float32 and float64; the lex batch's 32 root LPs of 2AP20 in
  float64) and at the fronts' lane counts (the first lanes of those rows:
  the XLA engine's mean lanes a wave, 5 at G2AP05, 27 at G3KP10, 36 at
  2AP20, 3 at G3AP05 in float64; the lex fronts' 2 a B&B step): ms per
  launch (CUDA events, median of 5 after a warm-up, with the host's
  launch), the largest and mean ``iters``, us a step (ms over the
  largest), the plan (shape, C, P, threads, layout) where the checkout
  has one, and a digest of every output (two runs whose digests agree
  returned the same outputs bit for bit);
* ``sweep`` (``--sweep``): the same rows under every plan that fits
  (``cuda_dense.loop_plans``: a warp a lane at P = 1, 2, 4 and 8; a
  block; clusters of 2, 4 and 8, with the tableau in shared and in global
  memory), each as above with the clusters the card
  holds at once; fails unless every plan returns the same outputs;
* ``clocks`` (``--clocks``): one launch per ``k5`` row of a variant built
  with ``-DK5_CLOCKS`` (the production build is unchanged), in which the
  first thread of each lane counts the SM cycles of each part of its run
  (PARTS); their sums over the lanes, shares, and cycles a step.

``--repo DIR`` imports ``moip_aira_tpu_torch`` and ``chip_smoke.py`` from
another checkout (which builds its kernels under its own ``build/``), so
two commits are timed on one card by runs of this script in one command
(parent, change, change, parent); ``--sweep`` needs a checkout whose K5
takes a plan.  Run from the root of a checkout:

    python3 tools/k5_bench.py [--repo DIR] [--fronts] [--sweep] [--clocks] [--seed N]
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import time
from contextlib import nullcontext

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the parts of a lane's run in a -DK5_CLOCKS build, in the kernel's order
PARTS = ("start", "row_sums", "phase_test", "pricing", "czv", "ratio_test",
         "row_pick", "outcome", "xb_step", "rank1", "barriers")
#: lanes a launch at the fronts K5 serves (PERF.md §5: the XLA engine's
#: LPs over its waves; the lex fronts' lanes over their batches)
FRONT_LANES = (
    ("G2AP05", "float32", 5, "xla"), ("G3KP10", "float32", 27, "xla"),
    ("2AP20", "float32", 36, "xla"), ("G3AP05", "float64", 3, "xla"),
    ("G2AP05", "float64", 2, "lex"), ("G3AP05", "float64", 2, "lex"),
    ("G3KP10", "float64", 2, "lex"),
)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def digest(out) -> str:
    h = hashlib.sha256()
    for f in out:
        h.update(f.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=HERE, help="checkout to import (default: this one)")
    ap.add_argument("--fronts", action="store_true", help="drive the fronts K5 serves")
    ap.add_argument("--sweep", action="store_true", help="time every plan that fits")
    ap.add_argument("--clocks", action="store_true", help="split a lane's cycles by part")
    ap.add_argument("--seed", type=int, default=0, help="chip_smoke.py's --seed")
    args = ap.parse_args()
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k5_bench: torch.cuda.is_available() is False")
    import chip_smoke as smoke
    from moip_aira_tpu_torch.io import read_problem
    from moip_aira_tpu_torch.solver import cuda_dense
    from moip_aira_tpu_torch.solver.simplex_dense import DenseLPSolver
    from moip_aira_tpu_torch.solver.xla_lp import F32_TOLERANCES

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    tag = os.path.basename(repo.rstrip("/"))
    planned = hasattr(cuda_dense, "loop_plans")
    if args.sweep and not planned:
        raise SystemExit(f"k5_bench: {repo}'s K5 takes no launch plan")

    def device_ms(prof, kernel):
        return sum(
            getattr(e, "device_time_total", 0.0)
            for e in prof.key_averages() if kernel in e.key
        ) / 1e3

    cuda_dense._lib()  # build K5 before anything is timed
    try:  # and K6, where the checkout has it
        from moip_aira_tpu_torch.solver import cuda_lex
        cuda_lex._lib()
    except ImportError:
        pass
    if args.fronts:
        from torch.profiler import ProfilerActivity, profile

        from moip_aira_tpu_torch.api import solve_front
        from moip_aira_tpu_torch.solver.cuda_lp import LAUNCHES, reset_launches
        from moip_aira_tpu_torch.solver.lex_torch import TorchLexBackend, make_lex_kernel
        from moip_aira_tpu_torch.solver.wave import WaveLexBackend

        def front_row(kind, name, dtype, run):
            p = read_problem(os.path.join(smoke.EXAMPLES, f"{name}.lp"))
            row = {}
            for label in ("time", "profile"):
                torch.cuda.synchronize()
                reset_launches()
                ctx = profile(activities=[ProfilerActivity.CUDA]) if label == "profile" \
                    else nullcontext()
                with ctx as prof:
                    t0 = time.perf_counter()
                    stats = run(p)
                    torch.cuda.synchronize()
                    seconds = time.perf_counter() - t0
                if label == "time":
                    row = {"kind": "fronts", "repo": tag, "front": kind, "instance": name,
                           "dtype": dtype, "seconds": seconds,
                           "k5_launches": LAUNCHES["simplex_dense"],
                           "k6_launches": LAUNCHES.get("lex_bnb", 0), **stats}
                else:
                    row["profiled_seconds"] = seconds
                    row["k5_device_ms"] = device_ms(prof, "simplex_dense")
                    row["k6_device_ms"] = device_ms(prof, "lex_bnb")
            emit(row)

        for name, dtype, workers, _ in smoke.XLA_FRONTS:
            def xla(p, dtype=dtype, workers=workers):
                be = WaveLexBackend(p, device="cuda", engine="xla", dtype=dtype,
                                    fragments=False, batch_width=2048, nodes_per_task=32)
                front = solve_front(p, n_workers=workers, backend=be, device="cuda", dp="off")
                if not np.array_equal(front.points, smoke.golden_front(p_name(p))):
                    raise AssertionError(f"{p_name(p)}: the XLA front differs from the golden")
                st = front.backend_stats
                return {"ips": int(front.ip_count), "waves": be.device_waves,
                        "lps": be.lp_count, "verify_fallbacks": be.verify_fallbacks,
                        "lp_steps": st["lp_steps"], "host_syncs": st["host_syncs"],
                        "mean_lanes": be.lp_count / max(1, be.device_waves),
                        "k5_plans": st.get("k5_plans"),
                        "lp_seconds": be.lp_kernel.seconds}

            front_row("xla", name, dtype, xla)
        for name, _, _, _ in smoke.LEX_FRONTS:
            def lex(p):
                be = TorchLexBackend(p, device="cuda")
                front = solve_front(p, n_workers=2, backend=be, device="cuda", dp="off")
                if not np.array_equal(front.points, smoke.golden_front(p_name(p))):
                    raise AssertionError(f"{p_name(p)}: the lex front differs from the golden")
                st = front.backend_stats
                return {"ips": int(front.ip_count), "batches": be.device_batches,
                        "lanes": be.lanes, "bnb_steps": getattr(be, "bnb_steps", None),
                        "lp_steps": getattr(be, "lp_steps", None),
                        "nodes": st.get("nodes"), "iters": st.get("iters"),
                        "path_iters": st.get("path_iters"), "host_syncs": be.host_syncs,
                        "k5_plans": st.get("k5_plans"), "k6_plans": st.get("k6_plans")}

            front_row("lex", name, "float64", lex)
        name, lanes = smoke.LEX_BATCH

        def batch(p, lanes=lanes):
            kern = make_lex_kernel(p, device="cuda")
            kern(*smoke.lex_batch(p, lanes))
            return {"lanes": lanes, "bnb_steps": getattr(kern, "bnb_steps", None),
                    "lp_steps": getattr(kern, "lp_steps", None),
                    "nodes": getattr(kern, "nodes", None), "iters": getattr(kern, "iters", None),
                    "host_syncs": kern.host_syncs}

        front_row("lex batch", name, "float64", batch)

    # the rows: (set, instance, dtype, lanes, W, (c, lo, hi))
    cases = []
    made = {}

    def lanes_of(name, dtype, kind):
        key = (name, dtype, kind)
        if key not in made:
            p = read_problem(os.path.join(smoke.EXAMPLES, f"{name}.lp"))
            W = np.hstack([np.vstack([p.A, p.C]), -np.eye(p.m_total)])
            if kind == "lex batch":
                arrays = smoke.lex_root_lanes(p, *smoke.lex_batch(p, smoke.LEX_BATCH[1]))
            else:
                lanes = dict(smoke.DENSE_LOOP_SHAPES).get(name, 64)
                rng = np.random.default_rng(args.seed + 2)
                arrays = smoke._lanes(p, rng, smoke.golden_front(name), lanes)
            made[key] = (torch.as_tensor(W, dtype=dtype, device=dev),
                         [torch.as_tensor(a, dtype=dtype, device=dev) for a in arrays])
        return made[key]

    for dtype in (torch.float32, torch.float64):
        for name, lanes in smoke.DENSE_LOOP_SHAPES:
            W, arrays = lanes_of(name, dtype, "wave lanes")
            cases.append(("dense-loop", name, dtype, lanes, W, arrays))
    W, arrays = lanes_of(smoke.LEX_BATCH[0], torch.float64, "lex batch")
    cases.append(("lex batch", smoke.LEX_BATCH[0], torch.float64, smoke.LEX_BATCH[1], W, arrays))
    for name, dt, lanes, front in FRONT_LANES:
        dtype = getattr(torch, dt)
        W, arrays = lanes_of(name, dtype, "wave lanes")
        cases.append((f"{front} front", name, dtype, lanes, W, [a[:lanes] for a in arrays]))

    def solver_of(W, dtype):
        tol = F32_TOLERANCES if dtype == torch.float32 else {}
        return DenseLPSolver(W, 2000, **tol)

    def launcher(W, dtype, arrays, plan=None, defines=()):
        s = solver_of(W, dtype)
        kw = {}
        if plan is not None:
            kw["plan"] = plan
        if defines:
            kw["defines"] = defines

        def fn():
            return cuda_dense.launch_dense_loop(
                W, *arrays, None, s.max_iters, s.feas_tol, s.cost_tol, s.pivot_tol,
                s.progress_tol, s.stall_limit, **kw,
            )

        return fn

    def row(kind, set_, name, dtype, k, fn, **extra):
        out = fn()
        torch.cuda.synchronize()
        ms = smoke.cuda_ms(fn)
        it = out.iters.double()
        emit({
            "kind": kind, "repo": tag, "set": set_, "instance": name,
            "dtype": str(dtype)[6:], "lanes": k, "ms": ms,
            "max_iters": int(it.max()), "mean_iters": float(it.mean()),
            "us_per_step": 1e3 * ms / max(1, int(it.max())), "digest": digest(out),
            **extra,
        })
        return digest(out)

    def plan_of(plan):
        return {"shape": plan.shape, "C": plan.C, "P": plan.P, "threads": plan.threads,
                "layout": plan.layout, "smem_bytes": plan.smem_bytes}

    for set_, name, dtype, k, W, arrays in cases:
        extra = {}
        if planned:
            extra = plan_of(cuda_dense.loop_plan(W, k))
        row("k5", set_, name, dtype, k, launcher(W, dtype, arrays), **extra)

    if args.sweep:
        for set_, name, dtype, k, W, arrays in cases:
            chosen = cuda_dense.loop_plan(W, k)
            seen = set()
            for plan in cuda_dense.loop_plans(W):
                seen.add(row(
                    "sweep", set_, name, dtype, k, launcher(W, dtype, arrays, plan),
                    **plan_of(plan), held=cuda_dense.max_clusters(dev.index or 0, plan),
                    chosen=plan == chosen,
                ))
            if len(seen) != 1:
                raise AssertionError(f"{name} {set_} {k} lanes: outputs differ by plan")

    if args.clocks:
        defines = ("-DK5_CLOCKS",)
        lib = cuda_dense._lib(defines)
        lib.simplex_dense_set_clocks.argtypes = [ctypes.c_void_p]
        lib.simplex_dense_set_clocks.restype = ctypes.c_int
        for set_, name, dtype, k, W, arrays in cases:
            buf = torch.zeros((k, len(PARTS)), dtype=torch.int64, device=dev)
            if lib.simplex_dense_set_clocks(buf.data_ptr()) != 0:
                raise RuntimeError("simplex_dense_set_clocks failed")
            out = launcher(W, dtype, arrays, defines=defines)()
            torch.cuda.synchronize()
            lib.simplex_dense_set_clocks(None)
            cyc = buf.cpu().numpy().astype(np.float64).sum(0)
            steps = float(out.iters.sum())
            extra = plan_of(cuda_dense.loop_plan(W, k)) if planned else {}
            emit({
                "kind": "clocks", "repo": tag, "set": set_, "instance": name,
                "dtype": str(dtype)[6:], "lanes": k, "steps": steps,
                "max_iters": int(out.iters.max()),
                "cycles": dict(zip(PARTS, cyc.tolist())),
                "share": dict(zip(PARTS, (cyc / max(1.0, cyc.sum())).tolist())),
                "cycles_a_step": dict(zip(PARTS[1:], (cyc[1:] / max(1.0, steps)).tolist())),
                "start_cycles_a_lane": cyc[0] / k, **extra,
            })
    return 0


def p_name(p) -> str:
    return os.path.splitext(os.path.basename(p.filename))[0]


if __name__ == "__main__":
    sys.exit(main())

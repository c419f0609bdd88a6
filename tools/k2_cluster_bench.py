#!/usr/bin/env python3
"""K2, the revised-simplex kernel, timed on the card.

Times K2 on the lanes that chip_smoke.py's phase ``revised`` makes (its
generator and seed): 2AP40 (82 x 1682) cold and with every other lane warm,
and 2AP100 (202 x 10202) cold, each on its first 1, 8, 31, 64 and 256
lanes.
Prints one JSON line per row, after the card's name and power limit:

* ``k2``: the launch the wrapper picks for those lanes; ms per launch (CUDA
  events, median of 5 after a warm-up), the launch's largest ``iters``, us
  a pivot (ms over that), the cluster size and layout when the wrapper
  reports them, and a digest of the raw outputs: two runs whose digests
  agree returned the same outputs bit for bit;
* ``sweep`` (``--sweep``): the same lanes at every cluster size C in
  {1, 2, 4, 8}, each with the layout the plan gives that C; fails unless
  every C returns the same outputs;
* ``wide`` (``--wide``): the full 2AP40 front as phase ``wide`` of
  chip_smoke.py drives it: seconds, IPs, waves, LPs, re-solves, K2's
  launches (by cluster size) and the host seconds by span.

``--repo DIR`` imports ``moip_aira_tpu_torch`` and ``chip_smoke.py`` from
another checkout (which builds its kernels under its own ``build/``), so
two commits are timed on one card by two runs of this script in one
command.  Run from the root of a checkout:

    python3 tools/k2_cluster_bench.py [--repo DIR] [--sweep] [--wide] [--seed N]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
from contextlib import nullcontext

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: 31 lanes: one more than the clusters of four the H100 holds at once
SUBSETS = (1, 8, 31, 64, 256)
LANES = 256
CLUSTERS = (1, 2, 4, 8)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def digest(out) -> str:
    h = hashlib.sha256()
    for t in out:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=HERE, help="checkout to import (default: this one)")
    ap.add_argument("--sweep", action="store_true", help="time every cluster size")
    ap.add_argument("--wide", action="store_true", help="drive the 2AP40 front")
    ap.add_argument("--seed", type=int, default=0, help="chip_smoke.py's --seed")
    args = ap.parse_args()
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k2_cluster_bench: torch.cuda.is_available() is False")
    import chip_smoke as smoke
    from moip_aira_tpu_torch.convert import lp_tensors
    from moip_aira_tpu_torch.io import read_problem
    from moip_aira_tpu_torch.solver import cuda_lp

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    tag = os.path.basename(repo.rstrip("/"))

    # phase `revised`'s generator: 2AP40's lanes first, then 2AP100's
    rng = np.random.default_rng(args.seed + 1)
    cases = []
    for name, starts in (("2AP40", ("cold", "warm")), ("2AP100", ("cold",))):
        p = read_problem(os.path.join(smoke.EXAMPLES, f"{name}.lp"))
        t = lp_tensors(p, dev)
        k2 = cuda_lp.make_cuda_rev_batch(t.W_dev, dev)
        (ct, lot, hit), _ = smoke.scaled_lanes(p, t.row_scale, rng, name, LANES, dev)
        wb0, wa0 = smoke.cold_start(LANES, p.m_total, p.n + p.m_total, dev)
        first = k2(ct, lot, hit, wb0, wa0)
        even = (torch.arange(LANES, device=dev) % 2 == 0)[:, None]
        wb_w = torch.where(even, first.basis, -1).contiguous()
        wa_w = torch.where(even, first.at_upper, 0).contiguous()
        both = {"cold": (wb0, wa0), "warm": (wb_w, wa_w)}
        for label in starts:
            cases.append((name, p, k2, (ct, lot, hit), label, both[label]))

    def row(kind, name, label, lanes, fn, **extra):
        out = fn()
        torch.cuda.synchronize()
        ms = smoke.cuda_ms(fn)
        it = int(out.iters.max())
        emit({
            "kind": kind, "repo": tag, "instance": name, "start": label,
            "lanes": lanes, "ms": ms, "max_iters": it,
            "mean_iters": float(out.iters.float().mean()),
            "us_per_pivot": 1e3 * ms / max(1, it), "digest": digest(out), **extra,
        })
        return digest(out)

    for name, p, k2, (ct, lot, hit), label, (wb, wa) in cases:
        for n in SUBSETS:
            a = (ct[:n], lot[:n], hit[:n], wb[:n], wa[:n])
            extra = {}
            if hasattr(k2, "plan"):
                plan = k2.plan(n)
                extra = {"C": plan.C, "layout": plan.layout, "threads": plan.threads}
            row("k2", name, label, n, lambda: k2(*a), **extra)

    if args.sweep:
        smem, _ = cases[0][2].device_limits
        for name, p, k2, (ct, lot, hit), label, (wb, wa) in cases:
            for n in SUBSETS:
                a = (ct[:n], lot[:n], hit[:n], wb[:n], wa[:n])
                seen = set()
                for C in CLUSTERS:
                    plan = cuda_lp.rev_plan_for(p.m_total, p.n, C, smem)
                    seen.add(row(
                        "sweep", name, label, n, lambda: k2.run(*a, plan),
                        C=C, layout=plan.layout, threads=plan.threads,
                        max_clusters=k2.max_clusters(plan),
                    ))
                if len(seen) != 1:
                    raise AssertionError(f"{name} {label} {n} lanes: outputs differ by C")

    if args.wide:
        from moip_aira_tpu_torch.api import solve_front
        from moip_aira_tpu_torch.solver.cuda_lp import LAUNCHES, reset_launches
        from moip_aira_tpu_torch.solver.wave import WaveLexBackend
        from moip_aira_tpu_torch.utils.trace import GLOBAL_TIMINGS

        try:
            from moip_aira_tpu_torch.utils.trace import recording
        except ImportError:  # an older checkout, whose spans always record
            recording = nullcontext

        p = read_problem(os.path.join(smoke.EXAMPLES, "2AP40.lp"))
        be = WaveLexBackend(p, device="cuda", fragments=False, batch_width=2048, nodes_per_task=32)
        spans0 = dict(GLOBAL_TIMINGS.totals)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        with recording():
            front = solve_front(p, backend=be, device="cuda")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if not np.array_equal(front.points, smoke.golden_front("2AP40")):
            raise AssertionError("2AP40: the front differs from the golden")
        emit({
            "kind": "wide", "repo": tag, "seconds": seconds, "ips": int(front.ip_count),
            "waves": be.device_waves, "lps": be.lp_count,
            "verify_fallbacks": be.verify_fallbacks,
            "launches": LAUNCHES["revised_simplex"],
            "cluster_sizes": dict(getattr(be.lp_kernel, "cluster_sizes", {})),
            "host_spans_seconds": {
                k: v - spans0.get(k, 0.0) for k, v in GLOBAL_TIMINGS.totals.items()
                if v - spans0.get(k, 0.0) > 0.0
            },
        })
    return 0


if __name__ == "__main__":
    sys.exit(main())

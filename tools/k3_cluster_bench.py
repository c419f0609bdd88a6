#!/usr/bin/env python3
"""K3, the B&B fragment kernel, timed on the card.

Times K3 on lanes made as chip_smoke.py's phase ``fragment`` makes them
(``scaled_lanes`` and ``fragment_par``, its seed): 2AP20 (42 x 442, F = 32, 8192 ticks) cold and with
every other lane warm from the first launch's final bases, and 2AP40 (82 x
1682, F = 8, 2000 ticks) cold.  Prints one JSON line per row, after the
card's name and power limit:

* ``fronts`` (``--fronts``, run first): the 2AP20 and 2AP40 fronts on the
  fragment path as chip_smoke.py's phases ``frag`` and ``frag-wide`` drive
  them: seconds, IPs, waves, records, ``host_recs``, K3's launches (by
  cluster size when the checkout counts them), the mean lanes a launch,
  and the host seconds by span (``frag.device_exec`` is the host waiting
  on K3);
* ``k3``: K3 on the first 1, 64 and all 256 lanes, and on the mean lanes a
  launch of each front when ``--fronts`` measured them, with the launch the
  wrapper picks: ms per launch (CUDA events, median of 5 after a warm-up),
  mean and largest pivots, us a mean pivot (ms over the mean pivots), the
  cluster size and layout when the wrapper reports them, and a digest of
  every raw output: two runs whose digests agree returned the same outputs
  bit for bit;
* ``sweep`` (``--sweep``): the same lanes at every cluster size C the
  shape allows, each with the layout ``bb_plan_for`` gives that C; fails
  unless every C returns the same outputs;
* ``clocks`` (``--clocks``): one launch per shape and start of a variant
  built with ``-DBB_TICK_CLOCKS`` (the production build is unchanged), in
  which block 0 of each lane counts the SM cycles of each part of a tick:
  restart, pivot start (y and the phase-1 sum), pivot, transition and
  backtrack; their sums over the lanes, shares and cycles each.

``--repo DIR`` imports ``moip_aira_tpu_torch`` and ``chip_smoke.py`` from
another checkout (which builds its kernels under its own ``build/``), so
two commits are timed on one card by two runs of this script in one
command; ``--sweep`` and ``--clocks`` need a checkout whose K3 takes a
plan.  Run from the root of a checkout:

    python3 tools/k3_cluster_bench.py [--repo DIR] [--fronts] [--sweep] [--clocks] [--seed N]
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
#: (instance, lanes, F, max_ticks, starts): phase ``fragment``'s shapes
SHAPES = (
    ("2AP20", 256, 32, 8192, ("cold", "warm")),
    ("2AP40", 256, 8, 2000, ("cold",)),
)
SUBSETS = (1, 64, 256)
FRONTS = (("frag", "2AP20"), ("frag-wide", "2AP40"))
PARTS = ("restart", "pivot_start", "pivot", "transition", "backtrack")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def digest(out: dict, fields) -> str:
    h = hashlib.sha256()
    for f in fields:
        h.update(out[f].cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=HERE, help="checkout to import (default: this one)")
    ap.add_argument("--fronts", action="store_true", help="drive the 2AP20 and 2AP40 fragment fronts")
    ap.add_argument("--sweep", action="store_true", help="time every cluster size")
    ap.add_argument("--clocks", action="store_true", help="split a tick's cycles by part")
    ap.add_argument("--seed", type=int, default=0, help="chip_smoke.py's --seed")
    args = ap.parse_args()
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k3_cluster_bench: torch.cuda.is_available() is False")
    import chip_smoke as smoke
    from moip_aira_tpu_torch.convert import lp_tensors
    from moip_aira_tpu_torch.io import read_problem
    from moip_aira_tpu_torch.solver import cuda_bb
    from moip_aira_tpu_torch.solver.bb_torch import FragmentOutcome

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    tag = os.path.basename(repo.rstrip("/"))
    planned = hasattr(cuda_bb, "bb_plan_for")
    if (args.sweep or args.clocks) and not planned:
        raise SystemExit(f"k3_cluster_bench: {repo}'s K3 takes no launch plan")

    front_lanes = {}
    if args.fronts:
        from moip_aira_tpu_torch.api import solve_front
        from moip_aira_tpu_torch.solver.cuda_lp import LAUNCHES, reset_launches
        from moip_aira_tpu_torch.solver.wave import WaveLexBackend
        from moip_aira_tpu_torch.utils.trace import GLOBAL_TIMINGS

        try:
            from moip_aira_tpu_torch.utils.trace import recording
        except ImportError:  # an older checkout, whose spans always record
            recording = nullcontext

        for phase, name in FRONTS:
            p = read_problem(os.path.join(smoke.EXAMPLES, f"{name}.lp"))
            be = WaveLexBackend(p, device="cuda", fragments=True)
            spans0 = dict(GLOBAL_TIMINGS.totals)
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            with recording():
                front = solve_front(p, n_workers=1, backend=be, device="cuda")
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            if not np.array_equal(front.points, smoke.golden_front(name)):
                raise AssertionError(f"{name}: the front differs from the golden")
            fs = be.frag_stats
            front_lanes[name] = int(round(fs["lanes"] / max(1, fs["waves"])))
            k3 = be.frag_kernel
            emit({
                "kind": "fronts", "repo": tag, "phase": phase, "instance": name,
                "seconds": seconds, "ips": int(front.ip_count), "waves": be.device_waves,
                "records": fs["records"], "host_recs": fs["host_recs"],
                "launches": LAUNCHES["bb_fragment"], "lanes": fs["lanes"],
                "mean_lanes": fs["lanes"] / max(1, fs["waves"]),
                "cluster_sizes": dict(getattr(k3, "cluster_sizes", {})),
                "launch_lanes": sorted(
                    [C, n, k] for (C, n), k in getattr(k3, "launch_lanes", {}).items()
                ),
                "host_spans_seconds": {
                    k: v - spans0.get(k, 0.0) for k, v in GLOBAL_TIMINGS.totals.items()
                    if v - spans0.get(k, 0.0) > 0.0
                },
            })

    # phase `fragment`'s generator and seed
    rng = np.random.default_rng(args.seed + 3)
    cases = []
    for name, lanes, F, max_ticks, starts in SHAPES:
        p = read_problem(os.path.join(smoke.EXAMPLES, f"{name}.lp"))
        t = lp_tensors(p, dev)
        n, m = p.n, p.m_total
        (ct, lot, hit), (c, lo, hi) = smoke.scaled_lanes(p, t.row_scale, rng, name, lanes, dev)
        par = torch.as_tensor(smoke.fragment_par(p, c, lo, hi, smoke.golden_front(name), F), device=dev)
        fn, meta = cuda_bb.make_cuda_bb_batch(
            t.W_dev, p.is_int, dev, F=F, D=128, node_iters=max(200, 6 * m), max_ticks=max_ticks,
        )
        wb0, wa0 = smoke.cold_start(lanes, m, n + m, dev)
        first = fn(ct, lot, hit, par, wb0, wa0)
        even = (torch.arange(lanes, device=dev) % 2 == 0)[:, None]
        fin_wa = torch.as_tensor(
            meta["unpack_atup1"](first["fin_atup"].cpu().numpy()), dtype=torch.int32, device=dev
        )
        both = {
            "cold": (wb0, wa0),
            "warm": (
                torch.where(even, first["fin_basis"], -1).contiguous(),
                torch.where(even, fin_wa, 0).contiguous(),
            ),
        }
        subs = sorted(set(SUBSETS) | {min(lanes, k) for k in front_lanes.values()})
        for label in starts:
            cases.append((name, p, fn, (ct, lot, hit, par), label, both[label], subs))

    def row(kind, name, label, lanes, fn, **extra):
        out = fn()._asdict()  # the raw outputs, as phase ``fragment`` times them
        torch.cuda.synchronize()
        ms = smoke.cuda_ms(fn)
        it = out["iters"].float()
        emit({
            "kind": kind, "repo": tag, "instance": name, "start": label,
            "lanes": lanes, "ms": ms, "mean_iters": float(it.mean()),
            "max_iters": int(it.max()), "records": int(out["nlog"].sum()),
            "us_per_mean_pivot": 1e3 * ms / max(1.0, float(it.mean())),
            "digest": digest(out, FragmentOutcome._fields), **extra,
        })
        return digest(out, FragmentOutcome._fields)

    for name, p, fn, (ct, lot, hit, par), label, (wb, wa), subs in cases:
        for k in subs:
            a = (ct[:k], lot[:k], hit[:k], par[:k], wb[:k], wa[:k])
            extra = {}
            if planned:
                plan = fn.plan(k)
                extra = {"C": plan.C, "layout": plan.layout, "threads": plan.threads}
            row("k3", name, label, k, lambda: fn._launch(*a), **extra)

    if args.sweep:
        from moip_aira_tpu_torch.solver.cuda_lp import cluster_sizes_for

        for name, p, fn, (ct, lot, hit, par), label, (wb, wa), subs in cases:
            smem, _ = fn.device_limits
            for k in subs:
                a = (ct[:k], lot[:k], hit[:k], par[:k], wb[:k], wa[:k])
                seen = set()
                for C in cluster_sizes_for(p.n + p.m_total):
                    plan = cuda_bb.bb_plan_for(p.m_total, p.n, fn.D, C, smem)
                    seen.add(row(
                        "sweep", name, label, k, lambda: fn._launch(*a, plan),
                        C=C, layout=plan.layout, threads=plan.threads,
                        max_clusters=fn.max_clusters(plan),
                    ))
                if len(seen) != 1:
                    raise AssertionError(f"{name} {label} {k} lanes: outputs differ by C")

    if args.clocks:
        defines = ("-DBB_TICK_CLOCKS",)
        lib = cuda_bb._bb_fragment_lib(defines)
        lib.bb_fragment_set_clocks.argtypes = [ctypes.c_void_p]
        lib.bb_fragment_set_clocks.restype = ctypes.c_int
        for name, p, fn, (ct, lot, hit, par), label, (wb, wa), subs in cases:
            fn.defines = defines  # launch the instrumented variant
            for k in sorted({1, subs[-1]}):
                buf = torch.zeros((k, 2 * len(PARTS)), dtype=torch.int64, device=dev)
                if lib.bb_fragment_set_clocks(buf.data_ptr()) != 0:
                    raise RuntimeError("bb_fragment_set_clocks failed")
                plan = fn.plan(k)
                fn._launch(ct[:k], lot[:k], hit[:k], par[:k], wb[:k], wa[:k], plan)
                torch.cuda.synchronize()
                lib.bb_fragment_set_clocks(None)
                tot = buf.cpu().numpy().astype(np.float64).sum(0)
                cyc, cnt = tot[: len(PARTS)], tot[len(PARTS):]
                emit({
                    "kind": "clocks", "repo": tag, "instance": name, "start": label,
                    "lanes": k, "C": plan.C, "layout": plan.layout,
                    "cycles": dict(zip(PARTS, cyc.tolist())),
                    "count": dict(zip(PARTS, cnt.tolist())),
                    "share": dict(zip(PARTS, (cyc / max(1.0, cyc.sum())).tolist())),
                    "cycles_each": dict(zip(PARTS, (cyc / np.maximum(cnt, 1)).tolist())),
                })
            fn.defines = ()
    return 0


if __name__ == "__main__":
    sys.exit(main())

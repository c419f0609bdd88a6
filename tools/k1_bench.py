#!/usr/bin/env python3
"""K1, the dense-tableau simplex, timed on the card.

Times K1 on lanes made as chip_smoke.py makes them (``scaled_lanes``, its
seeds) and prints one JSON line per row, after the card's name and power
limit:

* ``fronts`` (``--fronts``, run first): the fronts K1 serves, in this
  process, each run three times (a warm-up, a timed run, a profiled run):
  ``real`` (2AP20 with ``batch_width=2048``, as chip_smoke.py's phase
  ``real``), KP2D50 and G3KP10 with the settings of phase ``cli``
  (``solve_front(p, n_workers=2, backend="wave", device="cuda")``):
  seconds, IPs, waves, LPs, fallbacks, K1's launches (by plan shape, and
  by shape, C and lanes, when the checkout counts them), the mean lanes a
  launch, K1's device time over the front (torch.profiler) and, for
  ``real``, each launch's lanes, plan, largest pivots and device ms, and
  the host seconds by span (``wave.device_lp`` is the host waiting on K1);
* ``k1``: K1 with the launch the wrapper picks, on phase ``kernels``'
  lanes (2AP20 and G2AP05, 256 lanes, cold and with every other lane warm
  from the cold launch's bases), phase ``crossover``'s (2AP20 and 2AP40,
  256 cold lanes), and cold lanes at the fronts' launch sizes (2AP20 on 1
  lane and on ``real``'s mean lanes, G3KP10 and KP2D50 on their ``cli``
  means; 32, 27 and 212 unless ``--fronts`` measured them): ms per launch
  (CUDA events, median of 5 after a warm-up, which include the host's
  launch), the kernel's own device time (``device_us``, torch.profiler,
  mean of 5 launches), the largest and mean pivots of the launch's lanes,
  which lane ends the launch and the next largest pivots, us a pivot (ms
  over the largest), the plan's shape, C and layout when the checkout has
  one, and a digest of every raw output (two runs whose digests agree
  returned the same outputs bit for bit);
* ``sweep`` (``--sweep``): the same lanes under every plan the shape
  allows (a warp a lane at P = 1, 2, 4 and 8 lanes a block; a block; a
  cluster of 2, 4 and 8 blocks), each row as above; fails unless every
  plan returns the same outputs;
* ``clocks`` (``--clocks``): one launch per row with the wrapper's plan,
  of a variant built with ``-DK1_CLOCKS`` (the production build is
  unchanged), in which the first thread of each lane counts the SM cycles
  of each part of its run: the start (loading, the warm rebuild where
  present, the basic solution), the last pivot's rank-1 update with
  pricing, the pricing reduction (with the cluster's and the published
  entering column), the ratio test (with the least ratio), the row pick,
  the step's decision, the xB update and bookkeeping, and the sums (the
  next phase-1 sum beside the stall objective); their sums over the lanes,
  shares, and cycles a pivot.

``--repo DIR`` imports ``moip_aira_tpu_torch`` and ``chip_smoke.py`` from
another checkout (which builds its kernels under its own ``build/``), so
two commits are timed on one card by runs of this script in one command
(parent, change, change, parent); ``--sweep`` and ``--clocks`` need a
checkout whose K1 takes a plan.  Run from the root of a checkout:

    python3 tools/k1_bench.py [--repo DIR] [--fronts] [--sweep] [--clocks] [--seed N]
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
#: the fronts K1 serves: (label, instance, WaveLexBackend widths or None
#: for the cli phase's solve_front(n_workers=2, backend="wave"))
FRONTS = (
    ("real", "2AP20", dict(batch_width=2048, nodes_per_task=32)),
    ("cli", "KP2D50", None),
    ("cli", "G3KP10", None),
)
#: lanes a launch of each front, from the smoke's counts (LPs over waves,
#: PERF.md §5), unless --fronts measures them
FRONT_LANES = {"2AP20": 32, "KP2D50": 212, "G3KP10": 27}
PARTS = ("start", "update_pricing", "price_reduce", "ratio_test", "row_pick",
         "step", "xb_update", "sums")


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
    ap.add_argument("--fronts", action="store_true", help="drive the fronts K1 serves")
    ap.add_argument("--sweep", action="store_true", help="time every plan the shape allows")
    ap.add_argument("--clocks", action="store_true", help="split a lane's cycles by part")
    ap.add_argument("--seed", type=int, default=0, help="chip_smoke.py's --seed")
    args = ap.parse_args()
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k1_bench: torch.cuda.is_available() is False")
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
    planned = hasattr(cuda_lp, "dense_launch_plan")
    if (args.sweep or args.clocks) and not planned:
        raise SystemExit(f"k1_bench: {repo}'s K1 takes no launch plan")

    front_lanes = dict(FRONT_LANES)
    if args.fronts:
        from moip_aira_tpu_torch.api import solve_front
        from moip_aira_tpu_torch.solver.cuda_lp import LAUNCHES, reset_launches
        from moip_aira_tpu_torch.solver.wave import WaveLexBackend
        from moip_aira_tpu_torch.utils.trace import GLOBAL_TIMINGS

        try:
            from moip_aira_tpu_torch.utils.trace import recording
        except ImportError:  # an older checkout, whose spans always record
            recording = nullcontext

        from torch.profiler import ProfilerActivity, profile

        def k1_launches(prof):
            return sorted(
                (e for e in prof.events() if "dense_simplex" in e.name),
                key=lambda e: e.time_range.start,
            )

        for label, name, widths in FRONTS:
            p = read_problem(os.path.join(smoke.EXAMPLES, f"{name}.lp"))
            # a first run builds and warms up, the second is timed, the
            # third profiled (the profiler slows the host's launches)
            for run in ("warm", "time", "profile"):
                if run != "profile":
                    spans0 = dict(GLOBAL_TIMINGS.totals)
                    reset_launches()
                torch.cuda.synchronize()
                log = []
                ctx = profile(activities=[ProfilerActivity.CUDA]) if run == "profile" else nullcontext()
                with ctx as prof, recording():
                    t0 = time.perf_counter()
                    if widths is None:
                        front = solve_front(p, n_workers=2, backend="wave", device="cuda")
                    else:
                        be = WaveLexBackend(p, device="cuda", fragments=False, **widths)
                        # each launch's lanes, plan and largest pivots, in order
                        launch = be.lp_kernel._launch

                        def logged(c, *a, _launch=launch, _k1=be.lp_kernel, **kw):
                            out = _launch(c, *a, **kw)
                            pl = getattr(_k1, "_plans", {}).get(int(c.shape[0]))
                            log.append((int(c.shape[0]), f"{pl.shape} {pl.C}" if pl else "-", out.iters))
                            return out

                        be.lp_kernel._launch = logged
                        front = solve_front(p, backend=be, device="cuda")
                    torch.cuda.synchronize()
                    if run == "time":
                        seconds = time.perf_counter() - t0
                        launches = LAUNCHES["dense_simplex"]
                        spans = {
                            k: v - spans0.get(k, 0.0) for k, v in GLOBAL_TIMINGS.totals.items()
                            if v - spans0.get(k, 0.0) > 0.0
                        }
            kernels = k1_launches(prof)
            per_launch = [
                [lanes, plan, int(it.max()), e.device_time / 1e3]
                for (lanes, plan, it), e in zip(log, kernels)
            ]
            if not np.array_equal(front.points, smoke.golden_front(name)):
                raise AssertionError(f"{name}: the front differs from the golden")
            st = front.backend_stats
            if st.get("kernel") != "dense_simplex":
                raise AssertionError(f"{name}: served by {st.get('kernel')}, not K1")
            front_lanes[name] = max(1, round(st["lp_count"] / max(1, st["device_waves"])))
            emit({
                "kind": "fronts", "repo": tag, "phase": label, "instance": name,
                "seconds": seconds, "ips": int(front.ip_count), "waves": st["device_waves"],
                "lps": st["lp_count"], "verify_fallbacks": st["verify_fallbacks"],
                "launches": launches,
                "mean_lanes": st["lp_count"] / max(1, st["device_waves"]),
                "plan_shapes": st.get("plan_shapes"),
                "launch_lanes": (
                    smoke.lanes_by_plan(st["launch_lanes"]) if "launch_lanes" in st else None
                ),
                # K1's device time over the front (torch.profiler), and for
                # the real front each launch's [lanes, plan, largest pivots,
                # device ms]: both checkouts launch the same inputs in order
                "k1_device_ms": sum(e.device_time for e in kernels) / 1e3,
                "k1_kernels_profiled": len(kernels),
                "per_launch": per_launch,
                "host_spans_seconds": spans,
            })

    # the lanes of each row: (instance, start, lanes, inputs, K1)
    cases = []
    problems = {}

    def k1_for(name):
        if name not in problems:
            p = read_problem(os.path.join(smoke.EXAMPLES, f"{name}.lp"))
            t = lp_tensors(p, dev)
            problems[name] = (p, t, cuda_lp.make_cuda_lp_batch(t.W_dev, dev))
        return problems[name]

    def lanes_of(name, rng, count):
        p, t, k1 = k1_for(name)
        (ct, lot, hit), _ = smoke.scaled_lanes(p, t.row_scale, rng, name, count, dev)
        return (ct, lot, hit), smoke.cold_start(count, p.m_total, p.n + p.m_total, dev)

    rng = np.random.default_rng(args.seed)  # phase ``kernels``
    for name in ("2AP20", "G2AP05"):
        inputs, (wb, wa) = lanes_of(name, rng, 256)
        k1 = k1_for(name)[2]
        cold = k1(*inputs, wb, wa)
        even = (torch.arange(256, device=dev) % 2 == 0)[:, None]
        warm = (torch.where(even, cold.basis, -1).contiguous(),
                torch.where(even, cold.at_upper, 0).contiguous())
        cases.append(("kernels", name, "cold", 256, inputs, (wb, wa)))
        cases.append(("kernels", name, "warm", 256, inputs, warm))
    rng = np.random.default_rng(args.seed + 2)  # phase ``crossover``
    for name in ("2AP20", "2AP40"):
        inputs, start = lanes_of(name, rng, 256)
        cases.append(("crossover", name, "cold", 256, inputs, start))
    rng = np.random.default_rng(args.seed + 4)  # the fronts' launch sizes
    for name, sizes in (("2AP20", (1, front_lanes["2AP20"])), ("G3KP10", (front_lanes["G3KP10"],)),
                        ("KP2D50", (front_lanes["KP2D50"],))):
        count = max(sizes)
        inputs, (wb, wa) = lanes_of(name, rng, count)
        for k in sorted(set(sizes)):
            cases.append(("front", name, "cold", k, tuple(a[:k] for a in inputs), (wb[:k], wa[:k])))

    def device_us(fn, reps=5):
        """The mean device time of K1's launches in ``reps`` calls of fn,
        by torch.profiler: the kernel alone, without the host's launch."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if "dense_simplex" in e.key]
        total = sum(getattr(e, "device_time_total", 0.0) for e in events)
        return total / max(1, sum(e.count for e in events))

    def row(kind, set_, name, label, k, fn, **extra):
        out = fn()
        torch.cuda.synchronize()
        ms = smoke.cuda_ms(fn)
        it = out.iters.float()
        dg = digest(out)
        emit({
            "kind": kind, "repo": tag, "set": set_, "instance": name, "start": label,
            "lanes": k, "ms": ms, "device_us": device_us(fn), "max_iters": int(it.max()),
            "mean_iters": float(it.mean()),
            # the lane that ends the launch, and the next largest pivots
            "slowest_lane": int(it.argmax()),
            "second_iters": int(it.sort(descending=True).values[min(1, k - 1)]),
            "us_per_pivot": 1e3 * ms / max(1, int(it.max())), "digest": dg, **extra,
        })
        return dg

    for set_, name, label, k, inputs, (wb, wa) in cases:
        k1 = k1_for(name)[2]
        extra = {}
        if planned:
            plan = k1.plan(k)
            extra = {"shape": plan.shape, "C": plan.C, "P": plan.P, "layout": plan.layout,
                     "threads": plan.threads}
        row("k1", set_, name, label, k, lambda: k1(*inputs, wb, wa), **extra)

    if args.sweep:
        for set_, name, label, k, inputs, (wb, wa) in cases:
            p, _, k1 = k1_for(name)
            smem, _ = k1.device_limits
            m, n = p.m_total, p.n
            plans = []
            if cuda_lp.dense_packs(m, n + m):
                plans += [cuda_lp.dense_plan_for(m, n, "packed", 1, smem, P) for P in (1, 2, 4, 8)]
            for shape, C in (("block", 1), ("cluster", 2), ("cluster", 4), ("cluster", 8)):
                try:
                    plans.append(cuda_lp.dense_plan_for(m, n, shape, C, smem))
                except ValueError:
                    continue
            seen = set()
            for plan in plans:
                seen.add(row(
                    "sweep", set_, name, label, k, lambda: k1.run(*inputs, wb, wa, plan),
                    shape=plan.shape, C=plan.C, P=plan.P, layout=plan.layout,
                    threads=plan.threads, max_clusters=k1.max_clusters(plan),
                    chosen=plan == k1.plan(k),
                ))
            if len(seen) != 1:
                raise AssertionError(f"{name} {set_} {label} {k} lanes: outputs differ by plan")

    if args.clocks:
        defines = ("-DK1_CLOCKS",)
        lib = cuda_lp._dense_simplex_variant(defines)
        lib.dense_simplex_set_clocks.argtypes = [ctypes.c_void_p]
        lib.dense_simplex_set_clocks.restype = ctypes.c_int
        for set_, name, label, k, inputs, (wb, wa) in cases:
            k1 = k1_for(name)[2]
            buf = torch.zeros((k, len(PARTS)), dtype=torch.int64, device=dev)
            if lib.dense_simplex_set_clocks(buf.data_ptr()) != 0:
                raise RuntimeError("dense_simplex_set_clocks failed")
            k1.defines = defines  # launch the instrumented variant
            plan = k1.plan(k)
            out = k1.run(*inputs, wb, wa, plan)
            torch.cuda.synchronize()
            k1.defines = ()
            lib.dense_simplex_set_clocks(None)
            cyc = buf.cpu().numpy().astype(np.float64).sum(0)
            pivots = float(out.iters.sum())
            emit({
                "kind": "clocks", "repo": tag, "set": set_, "instance": name, "start": label,
                "lanes": k, "shape": plan.shape, "C": plan.C, "pivots": pivots,
                "cycles": dict(zip(PARTS, cyc.tolist())),
                "share": dict(zip(PARTS, (cyc / max(1.0, cyc.sum())).tolist())),
                "cycles_a_pivot": dict(zip(PARTS[1:], (cyc[1:] / max(1.0, pivots)).tolist())),
                "start_cycles_a_lane": cyc[0] / k,
            })
    return 0


if __name__ == "__main__":
    sys.exit(main())

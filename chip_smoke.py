#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (moip_aira_tpu_torch) on one GPU.

Drives the port's main paths on the card — read_problem -> solve_front ->
bound sweep (k=2) or AIRA scheduler (k>=3) -> WaveLexBackend -> the
hand-written CUDA kernels, K1 (dense tableau, LPs of n + m < 512 columns)
and K2 (revised simplex, wider LPs) on the per-LP path, K3 (B&B fragments,
a subtree per lane) on the fragment path -> f64 certification and audit ->
host branch and bound; and read_problem -> solve_front -> the knapsack
front DP, K4 (one launch per item) for single-capacity bi-objective
knapsacks — and fails unless every phase passes:

1. probe:     the card (nvidia-smi), torch, CUDA and nvcc versions;
2. build:     K1 (csrc/dense_simplex.cu), K2 (csrc/revised_simplex.cu),
              K3 (csrc/bb_fragment.cu) and K4 (csrc/kp_dp.cu), one nvcc
              each, started together, each timed;
3. kernels:   K1 against its plain PyTorch version on the card, at 2AP20's
              and G2AP05's LP shapes with 256 lanes (cold and half-warm):
              raw outputs equal bit for bit on every lane, then certified
              status and objective equal; each row with the plan K1's
              wrapper picks (shape: a warp, a block or a cluster of C
              blocks a lane; C; layout), the launch's largest and mean
              pivots and us a pivot (ms over the largest).  After phase
              `real` the same on new cold lanes at the fronts' launch
              sizes: 2AP20 on 1 lane and on `real`'s mean lanes (a
              cluster of more than one block, or the phase fails), G3KP10
              and KP2D50 on their `cli` means;
4. revised:   K2 against its plain version at 2AP40's LP shape (82 x 1682,
              256 lanes, cold and half-warm) and 2AP100's (202 x 10202, 64
              lanes, cold): K2 on the first 1, 8 and 64 lanes and on all of
              them, each launch with the cluster size C its plan picks (at
              least two sizes in all), raw outputs equal bit for bit to the
              plain version's rows on every lane, then how many lanes
              certify in f64; C, the layout and us a pivot (ms over the
              launch's largest iters);
5. crossover: K1 and K2 on the same cold lanes at 2AP20's and 2AP40's
              shapes (256 lanes): both times, their largest and mean
              pivots, K1's plan (2AP40 on a cluster of tableau slices, or
              the phase fails) and K2's C, and equal certified status and
              objective.  Phases 3-5 run the kernels at their wrappers'
              pivot cap of 2000; the fronts below take the backend's
              (solver/wave.py MAX_ITERS: 6000 for K2);
6. cli:       `python -m moip_aira_tpu_torch --backend wave --device cuda`
              on G2AP05, G3AP05, G3KP10 and KP2D50 (all K1), each .out held
              against its golden, with at most 5% of the LPs re-solved on
              the host; K1's launches by plan shape with their lanes
              (--stats), a warp a lane on at least one;
7. real:      the full 2AP20 front (n=400, m=42, K1) through solve_front,
              held against its golden, with the same bound on re-solves;
              K1's launches by plan shape with their lanes;
8. wide:      the full 2AP40 front (n=1600, m=82) through solve_front with
              the engine left to the backend (K2, warm starts on), held
              against its golden: K2 launched once per device wave, K1
              never, the same bound on re-solves; K2's launches by cluster
              size with their lanes, the clusters of each size the card
              holds, and how many launches that count moved off the C a
              cluster for every C SMs would give;
9. frag:      the full 2AP20 front through solve_front on the fragment path
              (WaveLexBackend(fragments=True), the backend's default
              widths), held against its golden: K3 launched once per device
              wave, K1 and K2 never, at most MAX_HOST_REC_SHARE of the
              logged records sent to exact host LPs, and no request handed
              whole to the exact host path; K3's launches by cluster size
              with their lanes, and the mean lanes a launch;
10. frag3:    G3AP05 (k=3, the scheduler ladder) on the fragment path and
              G3KP10 with frag_nodes=2 (budget stops, re-opened siblings),
              held the same way;
11. frag-wide: the full 2AP40 front on the fragment path, held the same way;
12. fragment: K3 against its plain version on the card at G3KP10's shape
              (256 lanes, F=32), 2AP20's (256 lanes, F=32, cold and half
              warm from the first launch's final bases) and 2AP40's (64
              lanes, F=8, 2000 ticks), then on new cold lanes at 2AP20's and
              2AP40's shapes as many as a launch of frag and frag-wide had
              on average in this run, and on the first one of them: every
              raw output of every lane equal bit for bit, each launch with
              the cluster size and layout K3's plan picks (printed, with us
              a mean pivot); fails unless 2AP20 prices from a shared-memory
              W and 2AP40 runs on a cluster with a shared-memory W slice;
13. dp-kernel: K4 against its plain version on the card at G2KP50, 2KP100
              and 2KP500 (generated, seed 1): the full final int32 table
              equal bit for bit, one launch per expanded item; K4's time for
              the whole DP and per item pass (CUDA events, median of 5), the
              plain version's, and the byte bound (dp_bound);
14. dp:       the DP path through solve_front: 2KP100 through the CLI with
              its defaults (.out against the golden), G2KP50 and the
              knapsack .mop with dp="on" (against their goldens), 2KP500
              with dp="auto" (against the plain version's front from phase
              13, nondominated, at least 2 points); every DP front with
              ip_count 0, K4 launched once per expanded item and K1-K3
              never.  Then G2KP50 and 2KP100 timed on the DP (dp="on")
              and on the AIRA engine (dp="off", kp_bb on the host), the
              measurement behind the n >= 80 rule of dp="auto";
15. lex:      the lex backend (backend="jax", solver/lex_torch.py: plain
              PyTorch in f64, none of K1-K4) on the card: G2AP05 (the
              sweep), G3AP05 and G3KP10 with n_workers=2 against their
              goldens and IPs (24 / 57 / 109), then one call of the lex
              kernel on 2AP20's 32 lanes (the initial rhs and golden points
              under both orderings) whose statuses, results and IPs must
              equal the same call's on the CPU; each row with seconds,
              batches, lanes, fallbacks, B&B and LP steps, host syncs and
              us an LP step; at most MAX_FALLBACK_SHARE of lanes may fall
              back;
16. mesh:     the twin of __graft_entry__.dryrun_multichip: G3AP05, 6
              workers, the wave backend with mesh_devices=8 on the card
              (one domain on a one-card machine), with K1 on every wave and
              the counts of the reference on one device (111 IPs, 8 rounds,
              domain_ips [68], pre_ips 43); then the distributed round of
              the lex kernel on G2AP05 (statuses 0, the front's two ends,
              their min and max).

Each phase prints one JSON line (phases 15-16 with the card's name and
power limit).  The last two lines are the kernel table
({"kernels": [...]}) and {"ok": true, "device": {...}}.  Any failure raises
and the exit code is not 0.  Run from the root of a checkout:

    python3 chip_smoke.py [--seed N]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
EXAMPLES = os.path.join(REPO, "examples")
CLI_INSTANCES = ("G2AP05", "G3AP05", "G3KP10", "KP2D50")
KERNEL_SHAPES = ("2AP20", "G2AP05")
#: K2's shapes: (instance, lanes, starts)
REVISED_SHAPES = (("2AP40", 256, ("cold", "warm")), ("2AP100", 64, ("cold",)))
#: K2 also runs on the first this many lanes of each shape: a lone lane and
#: a few take clusters of several blocks, a full batch one block a lane
REVISED_SUBSETS = (1, 8, 64)
CROSSOVER_SHAPES = ("2AP20", "2AP40")
KERNELS = ("dense_simplex", "revised_simplex", "bb_fragment", "kp_dp")
#: K4's instances: bundled, or generated by utils/generate.kp_lp (seed 1)
#: with this many items
DP_INSTANCES = (("G2KP50", None), ("2KP100", None), ("2KP500", 500))
#: K3's shapes: (instance, lanes, F, max_ticks, starts)
FRAGMENT_SHAPES = (
    ("G3KP10", 256, 32, 8192, ("cold",)),
    ("2AP20", 256, 32, 8192, ("cold", "warm")),
    ("2AP40", 64, 8, 2000, ("cold",)),
)
#: at most this share of a fragment front's logged records may fail the
#: audit and go to exact host LPs: the fragment path's counterpart of
#: MAX_FALLBACK_SHARE (a kernel whose claims do not certify shows there).
#: Twice the share the first H100 run measured on each front (PERF.md):
#: 79 of 10,060 records on 2AP20, 1 of 391 on G3AP05, 3 of 17,208 on
#: G3KP10 with frag_nodes=2, 3,166 of 54,170 on 2AP40
MAX_HOST_REC_SHARE = {"2AP20": 0.0158, "G3AP05": 0.0052, "G3KP10": 0.00035, "2AP40": 0.117}
LANES = 256
# the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W): HBM
# bytes per second and float32 operations per second outside the tensor
# cores; a kernel's bound is the larger of its bytes and its operations
# over these
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# int32 operations per second outside the tensor cores: 64 INT32 lanes an SM
# against 128 FP32 lanes (Hopper white paper), so half the float32 lane rate,
# 132 SMs x 64 x 1.98 GHz
PEAK_I32_PER_S = 16.7e12
OBJ_RTOL = 1e-3  # f32 objectives of two pivot paths (tests/test_simplex.py)
CERT_RTOL = 1e-7  # certified f64 optima of the same LP from two bases
# at most this share of a front's device LPs may fail f64 certification and
# be re-solved on the host (the H100 runs re-solve 0-0.16%)
MAX_FALLBACK_SHARE = 0.05
#: the lex backend's fronts (backend="jax", n_workers=2) and their IPs; its
#: fronts and the lex kernel's batch fail past MAX_FALLBACK_SHARE of their
#: lanes re-solved on the host
LEX_FRONTS = (("G2AP05", 24), ("G3AP05", 57), ("G3KP10", 109))
#: the lex kernel's batch at full width: 2AP20 (n = 400, m = 42, an f64
#: tableau of 42 x 442 a lane), the reference backend's 32 lanes
LEX_BATCH = ("2AP20", 32)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def golden_front(name):
    import numpy as np

    rows = []
    with open(os.path.join(EXAMPLES, f"{name}.out")) as fh:
        for line in fh:
            parts = line.split()
            if parts and all(p.lstrip("-").isdigit() for p in parts):
                rows.append([int(p) for p in parts])
    return np.array(rows)


def filtered(path):
    """The .out lines the golden contract binds: whitespace-insensitive,
    without the timing, IP-count and banner lines."""
    with open(path) as fh:
        return [
            line.split()
            for line in fh
            if not any(k in line for k in ("seconds", "solved", "Using"))
        ]


def cuda_ms(fn, reps=5):
    """Median milliseconds of ``fn()`` over ``reps`` runs, by CUDA events."""
    import torch

    fn()  # warm-up
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def check_fallbacks(name, fallbacks, lps):
    """Fail when too many of a front's device LPs fell back to the host: the
    exact host re-solves keep the front right, so only this count shows a
    kernel whose claims do not hold."""
    if fallbacks > MAX_FALLBACK_SHARE * lps:
        raise AssertionError(
            f"{name}: {fallbacks} of {lps} LPs re-solved on the host "
            f"(limit {MAX_FALLBACK_SHARE:.0%})"
        )


def bound(kernel, m, n, iters, warm_lanes, nlog=None):
    """The least time the card could take for one launch of ``kernel`` on
    these lanes, in ms, and what sets it ("bytes" or "operations").

    Bytes: W and each lane's inputs (c, lo, hi, wb, wa) read once, its
    outputs (status, obj, x, basis, at_upper, iters) written once; for K3
    the inputs add par, the outputs are best, bestx, four counters, the
    final basis and packed flags, and the logged records only (``nlog`` of
    them a lane, 8 scalars, the basis and ceil(nc / 32) flag words each).
    Operations, in float32 at 2 per multiply-add, from this run's pivot
    counts ``iters`` (bound flips counted as pivots) and warm lanes: the
    LP kernels start with the basic solution (2 m nc); each K1 iteration
    prices and updates the m x nc tableau (4 m nc) and a warm K1 lane
    rebuilds it in m steps (2 m^2 nc); each K2 iteration prices against W
    and computes y, alpha and the B^-1 update (2 (m nc + 3 m^2)) and a warm
    K2 lane rebuilds [P1 | -I] in m steps (4 m^3).  K3's pivots are K2's,
    its warm roots K2's rebuild, and each of its logged nodes restarts
    with the basic solution (2 (m nc + m^2)) and closes with the
    objective (2 (m + nc))."""
    import numpy as np

    nc = n + m
    B = len(iters)
    pivots = float(np.sum(iters))
    if kernel == "bb_fragment":
        nodes = float(np.sum(nlog))
        pw = -(-nc // 32)
        nbytes = 4 * (
            m * nc + B * (5 * nc + m + 4) + B * (5 + nc + m + pw)
            + nodes * (8 + m + pw)
        )
        ops = (
            pivots * 2 * (m * nc + 3 * m * m) + warm_lanes * 4 * m**3
            + nodes * 2 * (m * nc + m * m + m + nc)
        )
    else:
        nbytes = 4 * (m * nc + B * (4 * nc + m) + B * (3 + n + m + nc))
        if kernel == "dense_simplex":
            ops = pivots * 4 * m * nc + warm_lanes * 2 * m * m * nc
        else:
            ops = pivots * 2 * (m * nc + 3 * m * m) + warm_lanes * 4 * m**3
        ops += B * 2 * m * nc
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_F32_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def dp_bound(cells, passes):
    """The least time the card could take for ``passes`` item passes of K4
    over a table of ``cells`` int32 cells, in ms, and what sets it.

    Bytes: each pass must read the previous table once and write the new
    one once, 8 bytes a cell; a real table is far larger than the 50 MB L2,
    so nothing stays on chip from one pass to the next.  Operations: a
    compare, an add and a max a cell, 3 int32 operations, over the card's
    int32 rate outside the tensor cores.  Bytes set it: 8 / 3.35e12 s a
    cell against 3 / 16.7e12."""
    t_bytes = 8.0 * cells * passes / PEAK_BYTES_PER_S
    t_ops = 3.0 * cells * passes / PEAK_I32_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def events_ms(fn):
    """``fn()``'s result and its milliseconds, by CUDA events, one run."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def scaled_lanes(p, row_scale, rng, name, lanes, dev):
    """``_lanes`` of instance ``p`` as f32 CUDA tensors with the logical
    bounds row-scaled as the wave scales them, and the unscaled f64 arrays
    certification reads."""
    import torch

    c, lo, hi = _lanes(p, rng, golden_front(name), lanes)
    lo_s, hi_s = lo.copy(), hi.copy()
    lo_s[:, p.n :] *= row_scale
    hi_s[:, p.n :] *= row_scale

    def t32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()

    return (t32(c), t32(lo_s), t32(hi_s)), (c, lo, hi)


def cold_start(lanes, m, nc, dev):
    import torch

    return (
        torch.full((lanes, m), -1, dtype=torch.int32, device=dev),
        torch.zeros((lanes, nc), dtype=torch.int32, device=dev),
    )


def assert_bitwise(label, out_k, out_p):
    """Every raw output of every lane equal: the kernels and their plain
    versions sum in one fixed order.  Checked before certification, whose
    host re-solves would hide a kernel that gave up or claimed wrongly."""
    import torch

    for f in out_k._fields:
        a, b = getattr(out_k, f), getattr(out_p, f)
        if not torch.equal(a, b):
            diff = (a != b).reshape(a.shape[0], -1).any(dim=1)
            bad = torch.nonzero(diff).flatten()[:10].tolist()
            raise AssertionError(
                f"{label}: the kernel's raw {f} differs from the plain "
                f"version's on lanes {bad}"
            )


def card():
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def phase_probe():
    import torch

    smi = card()
    print(smi, flush=True)
    from moip_aira_tpu_torch.kernels.build import find_nvcc

    nvcc = subprocess.run(
        [find_nvcc(), "--version"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[-1]
    info = {
        "phase": "probe",
        "nvidia_smi": smi,
        "device": torch.cuda.get_device_name(0),
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "nvcc": nvcc,
        "cutlass": os.path.isdir("/usr/local/cutlass/include"),
        "python": sys.version.split()[0],
    }
    emit(info)
    return info


def phase_build():
    """All kernels built at once, one nvcc each."""
    from moip_aira_tpu_torch.kernels.build import build, load

    def timed(name):
        t0 = time.perf_counter()
        lib = build(name)
        return lib, time.perf_counter() - t0

    with ThreadPoolExecutor(len(KERNELS)) as pool:
        done = dict(zip(KERNELS, pool.map(timed, KERNELS)))
    for name in KERNELS:
        lib, seconds = done[name]
        load(name)
        emit({
            "phase": "build",
            "kernel": name,
            "seconds": seconds,
            "library": os.path.relpath(lib, REPO),
        })


def _lanes(problem, rng, front, lanes=LANES):
    """LP lanes as the wave builds them: per lane one stage objective, an
    objective-bound box (free, or cut inside the golden front's range) and,
    on about half the lanes, a few branching fixes of integer variables."""
    import numpy as np

    from moip_aira_tpu_torch import INF, Sense

    p = problem
    n, k = p.n, p.objcnt
    m = p.m_total
    is_min = p.objsen is Sense.MIN
    c = np.zeros((lanes, n + m))
    lo = np.zeros((lanes, n + m))
    hi = np.zeros((lanes, n + m))
    ints = np.flatnonzero(p.is_int)
    for b in range(lanes):
        j = int(rng.integers(k))
        c[b, :n] = (1.0 if is_min else -1.0) * p.C[j]
        srhs = np.full(k, INF if is_min else -INF)
        root = b < lanes // 8
        if not root:
            for jj in range(k):
                if rng.random() < 0.5:
                    srhs[jj] = float(
                        rng.integers(front[:, jj].min(), front[:, jj].max() + 1)
                    )
        olo, ohi = (np.full(k, -INF), srhs) if is_min else (srhs, np.full(k, INF))
        lo[b] = np.concatenate([p.lb, p.row_lb, olo])
        hi[b] = np.concatenate([p.ub, p.row_ub, ohi])
        if not root and rng.random() < 0.5 and ints.size:
            for v in rng.choice(ints, size=int(rng.integers(1, 7)), replace=False):
                lb_v = int(p.lb[v])
                val = float(rng.integers(lb_v, int(min(p.ub[v], lb_v + 1)) + 1))
                lo[b, v] = hi[b, v] = val
    return c, lo, hi


def k1_row(name, p, be, k1, inputs, unscaled, wb, wa, label, rows_kind):
    """K1 on ``inputs`` against dense_lp_batch_ref on the same CUDA inputs:
    raw outputs equal bit for bit on every lane, then certified status and
    objective equal; the launch's plan (shape, C, layout), its largest and
    mean pivots, us a pivot (ms over the largest: the lane that ends the
    launch), its time, the plain version's and the bound."""
    import numpy as np
    import torch

    from moip_aira_tpu_torch.solver.simplex_torch import OPTIMAL, dense_lp_batch_ref

    ct, lot, hit = inputs
    c, lo, hi = unscaled
    n, m = p.n, p.m_total
    lanes = int(ct.shape[0])
    W = k1.W
    plan = k1.plan(lanes)
    out_k = k1(ct, lot, hit, wb, wa)
    out_p = dense_lp_batch_ref(W, ct, lot, hit, wb, wa)
    torch.cuda.synchronize()
    assert_bitwise(f"K1 {name} {label} {lanes} lanes ({plan.shape}, C={plan.C})", out_k, out_p)
    sides = {}
    for side, out in (("kernel", out_k), ("plain", out_p)):
        st = out.status.cpu().numpy()
        f0 = be.verify_fallbacks
        st_c, objv, _ = be._certify_wave(
            c, lo, hi, st.copy(), out.basis.cpu().numpy(),
            out.at_upper.cpu().numpy(),
        )
        sides[side] = dict(
            claim=st, obj32=out.obj.cpu().numpy().astype(np.float64),
            status=st_c, obj=objv,
            cert_ok=int(be._last_cert.ok.sum()),
            resolved=be.verify_fallbacks - f0,
            iters=out.iters.cpu().numpy(),
        )
    K, P = sides["kernel"], sides["plain"]
    if K["resolved"] > P["resolved"]:
        raise AssertionError(
            f"{name} {label}: {K['resolved']} kernel lanes re-solved on "
            f"the host against the plain version's {P['resolved']}"
        )
    if not np.array_equal(K["status"], P["status"]):
        bad = np.flatnonzero(K["status"] != P["status"])
        raise AssertionError(
            f"{name} {label}: certified status differs on lanes {bad[:10]}"
        )
    opt = K["status"] == OPTIMAL
    if not np.allclose(
        K["obj"][opt], P["obj"][opt], rtol=CERT_RTOL, atol=CERT_RTOL
    ):
        raise AssertionError(f"{name} {label}: certified objectives differ")
    both = (K["claim"] == OPTIMAL) & (P["claim"] == OPTIMAL)
    err = np.abs(K["obj32"][both] - P["obj32"][both])
    lim = OBJ_RTOL * np.maximum(1.0, np.abs(P["obj32"][both]))
    if np.any(err > lim):
        raise AssertionError(f"{name} {label}: f32 objectives differ")
    ms = cuda_ms(lambda: k1(ct, lot, hit, wb, wa))
    plain_ms = cuda_ms(lambda: dense_lp_batch_ref(W, ct, lot, hit, wb, wa))
    bound_ms, bound_by = bound(
        "dense_simplex", m, n, K["iters"], int((wb[:, 0] >= 0).sum())
    )
    row = {
        "phase": "kernels",
        "kernel": "dense_simplex",
        "instance": name,
        "start": label,
        "rows": rows_kind,
        "m": m,
        "nc": n + m,
        "lanes": lanes,
        "shape": plan.shape,
        "C": plan.C,
        "P": plan.P,
        "layout": plan.layout,
        "threads": plan.threads,
        "optimal": int(opt.sum()),
        "infeasible": int((K["status"] == 1).sum()),
        "cert_ok_kernel": K["cert_ok"],
        "cert_ok_plain": P["cert_ok"],
        "host_resolved_kernel": K["resolved"],
        "host_resolved_plain": P["resolved"],
        "mean_iters_kernel": float(K["iters"].mean()),
        "mean_iters_plain": float(P["iters"].mean()),
        "max_iters": int(K["iters"].max()),
        "us_per_pivot": 1e3 * ms / max(1, int(K["iters"].max())),
        "bitwise_equal": True,
        "max_abs_err": float(err.max()) if err.size else 0.0,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
    }
    emit(row)
    return row


def k1_case(name, dev):
    """Instance ``name``, a backend that certifies exactly as a wave does
    (_certify_wave; its own K1 is not used here, so the main path's counts
    stay clean) and a K1 wrapper of its own."""
    from moip_aira_tpu_torch.convert import lp_tensors
    from moip_aira_tpu_torch.io import read_problem
    from moip_aira_tpu_torch.solver.cuda_lp import make_cuda_lp_batch
    from moip_aira_tpu_torch.solver.wave import WaveLexBackend

    p = read_problem(os.path.join(EXAMPLES, f"{name}.lp"))
    be = WaveLexBackend(p, device=dev, fragments=False)
    return p, be, make_cuda_lp_batch(lp_tensors(p, dev).W_dev, dev)


def phase_kernels(seed):
    """K1 against dense_lp_batch_ref on the same CUDA inputs, at 2AP20's
    and G2AP05's shapes with 256 lanes, cold and with every other lane
    warm from the cold launch's bases."""
    import numpy as np
    import torch

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed)
    rows = []
    for name in KERNEL_SHAPES:
        p, be, k1 = k1_case(name, dev)
        n, m = p.n, p.m_total
        inputs, unscaled = scaled_lanes(p, be._row_scale, rng, name, LANES, dev)
        wb_cold, wa_cold = cold_start(LANES, m, n + m, dev)
        cold = k1(*inputs, wb_cold, wa_cold)
        # half the lanes warm from the bases the kernel's cold pass returned
        warm_rows = torch.arange(LANES, device=dev) % 2 == 0
        wb_warm = torch.where(warm_rows[:, None], cold.basis, -1).contiguous()
        wa_warm = torch.where(warm_rows[:, None], cold.at_upper, 0).contiguous()
        for label, wb, wa in (("cold", wb_cold, wa_cold), ("warm", wb_warm, wa_warm)):
            rows.append(k1_row(name, p, be, k1, inputs, unscaled, wb, wa, label, "shape"))
    return rows


def phase_kernels_front(seed, front_lanes):
    """K1 against dense_lp_batch_ref on new cold lanes of each instance of
    ``front_lanes`` as many as a launch of its front had on average in
    this run (2AP20 also on one lane): the launches the fronts make, each
    with the plan K1's wrapper picks for them.  Fails unless the
    front-size 2AP20 launch runs on a cluster of more than one block."""
    import numpy as np
    import torch

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed + 4)
    rows = []
    for name, lanes in front_lanes.items():
        p, be, k1 = k1_case(name, dev)
        n, m = p.n, p.m_total
        (ct, lot, hit), (c, lo, hi) = scaled_lanes(p, be._row_scale, rng, name, lanes, dev)
        wb, wa = cold_start(lanes, m, n + m, dev)
        for k in sorted({1, lanes} if name == "2AP20" else {lanes}):
            rows.append(k1_row(
                name, p, be, k1, (ct[:k], lot[:k], hit[:k]), (c[:k], lo[:k], hi[:k]),
                wb[:k], wa[:k], "cold", "front",
            ))
    big = [r for r in rows if r["instance"] == "2AP20" and r["lanes"] == front_lanes.get("2AP20")]
    if not all(r["shape"] == "cluster" and r["C"] > 1 for r in big):
        raise AssertionError(f"K1's front-size 2AP20 launch did not run on a cluster: {big}")
    return rows


def phase_revised(seed):
    """K2 against revised_lp_batch_ref on the same CUDA inputs, at the
    shapes the wide front gives it: the plain version once on all of a
    shape's lanes, K2 on its first 1, 8, 64 and all lanes (a lane's outcome
    does not depend on its batch), each launch with the cluster size and
    layout the wrapper's plan picks for its lane count."""
    import numpy as np
    import torch

    from moip_aira_tpu_torch.convert import lp_tensors
    from moip_aira_tpu_torch.io import read_problem
    from moip_aira_tpu_torch.solver.cuda_lp import make_cuda_rev_batch
    from moip_aira_tpu_torch.solver.simplex_torch import LPOutcome, OPTIMAL, revised_lp_batch_ref
    from moip_aira_tpu_torch.solver.verify import LPVerifier

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed + 1)
    rows = []
    for name, lanes, starts in REVISED_SHAPES:
        p = read_problem(os.path.join(EXAMPLES, f"{name}.lp"))
        t = lp_tensors(p, dev)
        k2 = make_cuda_rev_batch(t.W_dev, dev)
        verifier = LPVerifier(t.W_np)
        n, m = p.n, p.m_total
        (ct, lot, hit), (c, lo, hi) = scaled_lanes(
            p, t.row_scale, rng, name, lanes, dev
        )
        wb_cold, wa_cold = cold_start(lanes, m, n + m, dev)
        first = k2(ct, lot, hit, wb_cold, wa_cold)
        # half the lanes warm from the bases the kernel's cold pass returned
        warm_rows = torch.arange(lanes, device=dev) % 2 == 0
        starts_wb = {
            "cold": (wb_cold, wa_cold),
            "warm": (
                torch.where(warm_rows[:, None], first.basis, -1).contiguous(),
                torch.where(warm_rows[:, None], first.at_upper, 0).contiguous(),
            ),
        }
        for label in starts:
            wb, wa = starts_wb[label]
            out_p, plain_ms = events_ms(
                lambda: revised_lp_batch_ref(k2.W, ct, lot, hit, wb, wa)
            )
            for sub in sorted({s for s in REVISED_SUBSETS if s < lanes} | {lanes}):
                args = (ct[:sub], lot[:sub], hit[:sub], wb[:sub], wa[:sub])
                plan = k2.plan(sub)
                out_k = k2(*args)
                assert_bitwise(
                    f"K2 {name} {label} {sub} lanes (C={plan.C})", out_k,
                    LPOutcome(*(f[:sub] for f in out_p)),
                )
                st = out_k.status.cpu().numpy()
                cert = verifier.certify(
                    c[:sub], lo[:sub], hi[:sub], st, out_k.basis.cpu().numpy(),
                    out_k.at_upper.cpu().numpy().astype(bool),
                )
                iters = out_k.iters.cpu().numpy()
                ms = cuda_ms(lambda: k2(*args))
                bound_ms, bound_by = bound(
                    "revised_simplex", m, n, iters, int((wb[:sub, 0] >= 0).sum())
                )
                row = {
                    "phase": "revised",
                    "kernel": "revised_simplex",
                    "instance": name,
                    "start": label,
                    "m": m,
                    "nc": n + m,
                    "lanes": sub,
                    "C": plan.C,
                    "layout": plan.layout,
                    "threads": plan.threads,
                    "optimal": int((st == OPTIMAL).sum()),
                    "infeasible": int((st == 1).sum()),
                    "cert_ok": int(cert.ok.sum()),
                    "mean_iters": float(iters.mean()),
                    "max_iters": int(iters.max()),
                    "us_per_pivot": 1e3 * ms / max(1, int(iters.max())),
                    "bitwise_equal": True,
                    "max_abs_err": 0.0,
                    "ms": ms,
                    # the plain version ran once, on all of the shape's lanes
                    "plain_ms": plain_ms,
                    "plain_lanes": lanes,
                    "bound_ms": bound_ms,
                    "bound_by": bound_by,
                }
                emit(row)
                rows.append(row)
    if len({r["C"] for r in rows}) < 2:
        raise AssertionError(f"K2 launched one cluster size only: {sorted({r['C'] for r in rows})}")
    return rows


def fragment_par(problem, c, lo, hi, front, F):
    """par (lanes, 4) for K3's lanes: the incumbent is +inf on the even
    lanes and, on the odd ones, the stage value of the worst golden front
    point inside the lane's objective box (a feasible value; +inf when no
    point is inside); integral objectives; a budget of F; all active."""
    import numpy as np

    from moip_aira_tpu_torch import Sense

    p = problem
    n, k = p.n, p.objcnt
    is_min = p.objsen is Sense.MIN
    sign = 1.0 if is_min else -1.0
    lanes = c.shape[0]
    par = np.zeros((lanes, 4), np.float32)
    par[:, 0] = np.inf
    par[:, 1:] = [1.0, F, 1.0]
    box = hi[:, -k:] if is_min else lo[:, -k:]
    for b in range(1, lanes, 2):
        j = next(jj for jj in range(k) if np.array_equal(c[b, :n], sign * p.C[jj]))
        inside = (front <= box[b]).all(1) if is_min else (front >= box[b]).all(1)
        if inside.any():
            par[b, 0] = (sign * front[inside, j]).max()
    return par


def fragment_case(p, t, rng, name, lanes, F, max_ticks, dev):
    """K3's wrapper and ``lanes`` fragment roots of instance ``p`` (made
    from the golden front's requests, see ``fragment_par``), cold."""
    import torch

    from moip_aira_tpu_torch.solver.cuda_bb import make_cuda_bb_batch

    n, m = p.n, p.m_total
    (ct, lot, hit), (c, lo, hi) = scaled_lanes(p, t.row_scale, rng, name, lanes, dev)
    par = torch.as_tensor(fragment_par(p, c, lo, hi, golden_front(name), F), device=dev)
    node_iters = max(200, 6 * m)  # the wave's per-node cap
    fn, meta = make_cuda_bb_batch(
        t.W_dev, p.is_int, dev, F=F, D=128, node_iters=node_iters, max_ticks=max_ticks,
    )
    return fn, meta, (ct, lot, hit, par), cold_start(lanes, m, n + m, dev)


def fragment_rows(name, p, fn, inputs, wb, wa, subsets, label, row_kind):
    """K3 against fragment_batch_ref on the same CUDA inputs: the plain
    version once on all the lanes, K3 on the first ``subsets`` of them (a
    lane's walk does not depend on its batch), each launch with the cluster
    size and layout the wrapper's plan picks for its lane count; every raw
    output of every lane equal bit for bit."""
    import numpy as np

    from moip_aira_tpu_torch.solver.bb_torch import (
        F_ACTION, FragmentOutcome, LS_BUDGET, LS_TICKS, fragment_batch_ref,
    )

    actions = ("branch", "prune", "infeasible", "leaf", "iterlim")
    ct, lot, hit, par = inputs
    n, m, F = p.n, p.m_total, fn.F
    out_p, plain_ms = events_ms(
        lambda: fragment_batch_ref(
            fn.W, p.is_int, ct, lot, hit, par, wb, wa, F=F, D=fn.D,
            node_iters=fn.node_iters, max_ticks=fn.max_ticks,
        )
    )
    rows = []
    for sub in subsets:
        args = (ct[:sub], lot[:sub], hit[:sub], par[:sub], wb[:sub], wa[:sub])
        plan = fn.plan(sub)
        out_k = fn(*args)
        raw = FragmentOutcome(**{f: out_k[f] for f in FragmentOutcome._fields})
        assert_bitwise(
            f"K3 {name} {label} {sub} lanes (C={plan.C})", raw,
            FragmentOutcome(*(f[:sub] for f in out_p)),
        )
        ms = cuda_ms(lambda: fn._launch(*args))
        nlog = raw.nlog.cpu().numpy()
        iters = raw.iters.cpu().numpy()
        acts = np.concatenate(
            [raw.lg_scal[b, : min(k, F), F_ACTION].cpu().numpy() for b, k in enumerate(nlog)]
        ).astype(int)
        lstate = raw.lstate.cpu().numpy()
        bound_ms, bound_by = bound(
            "bb_fragment", m, n, iters, int((wb[:sub, 0] >= 0).sum()), nlog
        )
        row = {
            "phase": "fragment",
            "kernel": "bb_fragment",
            "instance": name,
            "start": label,
            "rows": row_kind,
            "m": m,
            "nc": n + m,
            "lanes": sub,
            "C": plan.C,
            "layout": plan.layout,
            "threads": plan.threads,
            "F": F,
            "max_ticks": fn.max_ticks,
            "records": int(nlog.sum()),
            "records_by_action": {
                a: int((acts == i).sum()) for i, a in enumerate(actions)
            },
            "budget_stops": int((lstate == LS_BUDGET).sum()),
            "tick_stops": int((lstate == LS_TICKS).sum()),
            "max_ticks_used": int(raw.ticks.max()),
            "mean_iters": float(iters.mean()),
            "max_iters": int(iters.max()),
            "us_per_mean_pivot": 1e3 * ms / max(1.0, float(iters.mean())),
            "bitwise_equal": True,
            "max_abs_err": 0.0,
            "ms": ms,
            # the plain version ran once, on all of the set's lanes
            "plain_ms": plain_ms,
            "plain_lanes": int(ct.shape[0]),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
        }
        emit(row)
        rows.append(row)
    return rows


def phase_fragment(seed, front_lanes):
    """K3 against fragment_batch_ref on the same CUDA inputs, at the shapes
    the fragment fronts give it: the lanes of FRAGMENT_SHAPES, then, for
    each instance of ``front_lanes``, a set of as many lanes as a launch of
    its front had on average in this run, on all of them and on one."""
    import numpy as np
    import torch

    from moip_aira_tpu_torch.convert import lp_tensors
    from moip_aira_tpu_torch.io import read_problem

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed + 3)
    rows = []
    shapes = {}
    for name, lanes, F, max_ticks, starts in FRAGMENT_SHAPES:
        p = read_problem(os.path.join(EXAMPLES, f"{name}.lp"))
        t = lp_tensors(p, dev)
        shapes[name] = (p, t, F, max_ticks)
        fn, meta, inputs, (wb_cold, wa_cold) = fragment_case(
            p, t, rng, name, lanes, F, max_ticks, dev
        )
        first = fn(*inputs, wb_cold, wa_cold)
        # half the lanes warm from the bases the first launch stopped with
        even = (torch.arange(lanes, device=dev) % 2 == 0)[:, None]
        fin_wa = torch.as_tensor(
            meta["unpack_atup1"](first["fin_atup"].cpu().numpy()), dtype=torch.int32,
            device=dev,
        )
        starts_wb = {
            "cold": (wb_cold, wa_cold),
            "warm": (
                torch.where(even, first["fin_basis"], -1).contiguous(),
                torch.where(even, fin_wa, 0).contiguous(),
            ),
        }
        for label in starts:
            wb, wa = starts_wb[label]
            rows += fragment_rows(name, p, fn, inputs, wb, wa, (lanes,), label, "shape")
    for name, lanes in front_lanes.items():
        p, t, F, max_ticks = shapes[name]
        fn, _, inputs, (wb, wa) = fragment_case(p, t, rng, name, lanes, F, max_ticks, dev)
        rows += fragment_rows(
            name, p, fn, inputs, wb, wa, sorted({1, lanes}), "cold", "front"
        )
    # the plans this card gives: all of W in shared memory at 2AP20, a W
    # slice in shared memory on a cluster at 2AP40
    if not all("W" in r["layout"] for r in rows if r["instance"] == "2AP20"):
        raise AssertionError("K3 at 2AP20 did not price from a shared-memory W")
    if not any(r["C"] > 1 and "W" in r["layout"] for r in rows if r["instance"] == "2AP40"):
        raise AssertionError("K3 at 2AP40 never ran on a cluster with a shared-memory W slice")
    return rows


def phase_crossover(seed):
    """K1 and K2 on the same cold lanes, where the reference's threshold
    (n + m >= 512) switches between them: both times, and the same
    certified answers."""
    import numpy as np
    import torch

    from moip_aira_tpu_torch.convert import lp_tensors
    from moip_aira_tpu_torch.io import read_problem
    from moip_aira_tpu_torch.solver.cuda_lp import make_cuda_lp_batch, make_cuda_rev_batch
    from moip_aira_tpu_torch.solver.simplex_torch import OPTIMAL
    from moip_aira_tpu_torch.solver.wave import WaveLexBackend

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed + 2)
    rows = []
    for name in CROSSOVER_SHAPES:
        p = read_problem(os.path.join(EXAMPLES, f"{name}.lp"))
        t = lp_tensors(p, dev)
        be = WaveLexBackend(p, device=dev, fragments=False)  # certifies only
        n, m = p.n, p.m_total
        (ct, lot, hit), (c, lo, hi) = scaled_lanes(
            p, t.row_scale, rng, name, LANES, dev
        )
        wb, wa = cold_start(LANES, m, n + m, dev)
        sides = {}
        for kname, make in (("K1", make_cuda_lp_batch), ("K2", make_cuda_rev_batch)):
            kern = make(t.W_dev, dev)
            out = kern(ct, lot, hit, wb, wa)
            st_c, objv, _ = be._certify_wave(
                c, lo, hi, out.status.cpu().numpy(), out.basis.cpu().numpy(),
                out.at_upper.cpu().numpy(),
            )
            sides[kname] = dict(
                status=st_c, obj=objv, iters=out.iters.cpu().numpy(),
                ms=cuda_ms(lambda: kern(ct, lot, hit, wb, wa)), plan=kern.plan(LANES),
            )
        k1, k2 = sides["K1"], sides["K2"]
        if not np.array_equal(k1["status"], k2["status"]):
            bad = np.flatnonzero(k1["status"] != k2["status"])
            raise AssertionError(f"{name}: K1 and K2 certify other statuses on {bad[:10]}")
        opt = k1["status"] == OPTIMAL
        if not np.allclose(k1["obj"][opt], k2["obj"][opt], rtol=CERT_RTOL, atol=CERT_RTOL):
            raise AssertionError(f"{name}: K1 and K2 certify other objectives")
        row = {
            "phase": "crossover",
            "instance": name,
            "m": m,
            "nc": n + m,
            "lanes": LANES,
            "optimal": int(opt.sum()),
            "k1_ms": k1["ms"],
            "k2_ms": k2["ms"],
            "k1_mean_iters": float(k1["iters"].mean()),
            "k2_mean_iters": float(k2["iters"].mean()),
            # a launch lasts as long as its slowest lane
            "k1_max_iters": int(k1["iters"].max()),
            "k2_max_iters": int(k2["iters"].max()),
            "k1_shape": k1["plan"].shape,
            "k1_C": k1["plan"].C,
            "k1_layout": k1["plan"].layout,
            "k2_C": k2["plan"].C,
        }
        emit(row)
        rows.append(row)
    wide = [r for r in rows if r["instance"] == "2AP40"]
    if not all(r["k1_shape"] == "cluster" and r["k1_C"] > 1 for r in wide):
        raise AssertionError(f"K1 at 2AP40 did not run on a cluster of tableau slices: {wide}")
    return rows


def lanes_by_plan(rows):
    """K1's launches as [shape, C, lanes, launches] rows, by "shape C":
    how many, and the least, mean and largest lanes a launch."""
    by = {}
    for shape, C, lanes, k in sorted(rows):
        d = by.setdefault(f"{shape} {C}", {"launches": 0, "lanes": 0, "min": lanes, "max": lanes})
        d["launches"] += k
        d["lanes"] += k * lanes
        d["min"] = min(d["min"], lanes)
        d["max"] = max(d["max"], lanes)
    for d in by.values():
        d["mean"] = d.pop("lanes") / d["launches"]
    return by


def phase_cli():
    """The main path through the port's CLI, one process per instance."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for name in CLI_INSTANCES:
            out = os.path.join(tmp, f"{name}.out")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [
                    sys.executable, "-m", "moip_aira_tpu_torch",
                    "-p", os.path.join(EXAMPLES, f"{name}.lp"), "-o", out,
                    "--backend", "wave", "--device", "cuda", "-t", "2",
                    "--stats",
                ],
                cwd=REPO, env=env, capture_output=True, text=True,
            )
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(
                    f"CLI failed on {name} (exit {proc.returncode}):\n"
                    f"{proc.stderr[-4000:]}"
                )
            stats = None
            for line in proc.stderr.splitlines():
                if line.startswith("[stats] {"):
                    stats = json.loads(line[len("[stats] "):])
            if stats is None:
                raise RuntimeError(f"CLI printed no backend stats on {name}")
            if filtered(out) != filtered(os.path.join(EXAMPLES, f"{name}.out")):
                raise AssertionError(f"{name}: the front differs from the golden")
            launches = stats.get("kernel_launches", 0)
            if stats.get("kernel") != "dense_simplex" or not (
                launches > 0 and launches == stats["device_waves"]
            ):
                raise AssertionError(
                    f"{name}: {stats.get('kernel')} launches {launches}, "
                    f"device waves {stats['device_waves']} (want K1 on each)"
                )
            check_fallbacks(name, stats["verify_fallbacks"], stats["lp_count"])
            ips = next(
                int(line.split()[0]) for line in open(out) if "IPs solved" in line
            )
            row = {
                "phase": "cli",
                "instance": name,
                "seconds": seconds,
                "ips": ips,
                "waves": stats["device_waves"],
                "lps": stats["lp_count"],
                "verify_fallbacks": stats["verify_fallbacks"],
                "launches": launches,
                "mean_lanes": stats["lp_count"] / max(1, stats["device_waves"]),
                # K1's launches by plan shape, and by shape and C with lanes
                "plan_shapes": stats.get("plan_shapes"),
                "lanes_by_plan": lanes_by_plan(stats.get("launch_lanes", [])),
                "golden": True,
            }
            emit(row)
            rows.append(row)
    if not any((r["plan_shapes"] or {}).get("packed") for r in rows):
        raise AssertionError("K1 ran a warp a lane on no cli instance")
    return rows


def lanes_by_cluster(launch_lanes):
    """A wrapper's launches by cluster size C: how many, and the least,
    mean and largest lanes a launch."""
    by = {}
    for (C, lanes), k in sorted(launch_lanes.items()):
        d = by.setdefault(C, {"launches": 0, "lanes": 0, "min": lanes, "max": lanes})
        d["launches"] += k
        d["lanes"] += k * lanes
        d["max"] = lanes
    for d in by.values():
        d["mean"] = d.pop("lanes") / d["launches"]
    return by


def phase_front(phase, name, kernel):
    """The full front of ``name`` at the bench's widths, in this process,
    with the LP engine left to the backend's shape rule: ``kernel`` must
    serve every device wave and the other kernel none."""
    import numpy as np
    import torch

    from moip_aira_tpu_torch.api import solve_front
    from moip_aira_tpu_torch.io import read_problem
    from moip_aira_tpu_torch.solver.cuda_lp import LAUNCHES, reset_launches
    from moip_aira_tpu_torch.solver.wave import WaveLexBackend
    from moip_aira_tpu_torch.utils.trace import GLOBAL_TIMINGS

    p = read_problem(os.path.join(EXAMPLES, f"{name}.lp"))
    be = WaveLexBackend(
        p, device="cuda", fragments=False, batch_width=2048, nodes_per_task=32
    )
    spans0 = dict(GLOBAL_TIMINGS.totals)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    front = solve_front(p, backend=be, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    # host seconds by span: wave.device_lp is the host waiting on the card
    spans = {
        k: v - spans0.get(k, 0.0)
        for k, v in GLOBAL_TIMINGS.totals.items()
        if v - spans0.get(k, 0.0) > 0.0
    }
    if not np.array_equal(front.points, golden_front(name)):
        raise AssertionError(f"{name}: the front differs from the golden")
    others = {k: v for k, v in launches.items() if k != kernel}
    if not (
        be.lp_kernel.kernel == kernel
        and launches[kernel] > 0
        and launches[kernel] == be.device_waves
        and not any(others.values())
    ):
        raise AssertionError(
            f"{name}: launches {launches} over {be.device_waves} device waves "
            f"(want {kernel} on each, no other kernel)"
        )
    check_fallbacks(name, be.verify_fallbacks, be.lp_count)
    kern = be.lp_kernel
    is_k1 = kern.kernel == "dense_simplex"
    plan_moves = None
    if not is_k1:
        # the launches whose C this card's cluster count moved: the plan
        # before it read the card assumed a cluster for every C SMs
        from moip_aira_tpu_torch.solver.cuda_lp import rev_launch_plan

        smem, sms = kern.device_limits
        assumed = {C: sms // C for C in kern.held}
        plan_moves = sum(
            k for (C, lanes), k in kern.launch_lanes.items()
            if rev_launch_plan(kern.m, kern.n, lanes, smem, sms, assumed).C != C
        )
    row = {
        "phase": phase,
        "instance": name,
        "engine": be.engine,
        "warm_start": be.warm_start,
        "seconds": seconds,
        "points": int(front.points.shape[0]),
        "ips": int(front.ip_count),
        "waves": be.device_waves,
        "lps": be.lp_count,
        "verify_fallbacks": be.verify_fallbacks,
        "launches": launches[kernel],
        # K2's launches by cluster size, their lanes, and how many of them
        # the clusters the card holds moved off the C a cluster for every C
        # SMs would give
        "cluster_sizes": dict(kern.cluster_sizes),
        "lanes_by_C": None if is_k1 else lanes_by_cluster(kern.launch_lanes),
        "clusters_held": dict(getattr(kern, "held", {})) if plan_moves is not None else None,
        "launches_moved_by_held": plan_moves,
        "mean_lanes": be.lp_count / max(1, be.device_waves),
        # K1's launches by plan shape, and by shape and C with lanes
        "plan_shapes": dict(kern.plan_shapes) if is_k1 else None,
        "lanes_by_plan": lanes_by_plan(
            [shape, C, n, k] for (shape, C, n), k in kern.launch_lanes.items()
        ) if is_k1 else None,
        "host_spans_seconds": spans,
        "golden": True,
    }
    emit(row)
    return row


def phase_frag_front(phase, name, workers, **kw):
    """The full front of ``name`` on the fragment path, in this process:
    K3 must serve every device wave and the LP kernels none, at most
    MAX_HOST_REC_SHARE[name] of the logged records may go to exact host
    LPs, and no request may fall back whole to the host."""
    import numpy as np
    import torch

    from moip_aira_tpu_torch.api import solve_front
    from moip_aira_tpu_torch.io import read_problem
    from moip_aira_tpu_torch.solver.cuda_lp import LAUNCHES, reset_launches
    from moip_aira_tpu_torch.solver.wave import WaveLexBackend
    from moip_aira_tpu_torch.utils.trace import GLOBAL_TIMINGS

    p = read_problem(os.path.join(EXAMPLES, f"{name}.lp"))
    be = WaveLexBackend(p, device="cuda", fragments=True, **kw)
    spans0 = dict(GLOBAL_TIMINGS.totals)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    front = solve_front(p, n_workers=workers, backend=be, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    spans = {
        k: v - spans0.get(k, 0.0)
        for k, v in GLOBAL_TIMINGS.totals.items()
        if v - spans0.get(k, 0.0) > 0.0
    }
    if not np.array_equal(front.points, golden_front(name)):
        raise AssertionError(f"{name} ({phase}): the front differs from the golden")
    others = {k: v for k, v in launches.items() if k != "bb_fragment"}
    if not (
        launches["bb_fragment"] > 0
        and launches["bb_fragment"] == be.device_waves
        and not any(others.values())
    ):
        raise AssertionError(
            f"{name} ({phase}): launches {launches} over {be.device_waves} "
            f"device waves (want bb_fragment on each, no other kernel)"
        )
    fs = be.frag_stats
    limit = MAX_HOST_REC_SHARE[name]
    if fs["host_recs"] > limit * fs["records"]:
        raise AssertionError(
            f"{name} ({phase}): {fs['host_recs']} of {fs['records']} records "
            f"went to exact host LPs (limit {limit:.2%})"
        )
    if fs.get("req_fallbacks", 0):
        raise AssertionError(
            f"{name} ({phase}): {fs['req_fallbacks']} requests fell back whole "
            f"to the exact host path"
        )
    k3 = be.frag_kernel
    row = {
        "phase": phase,
        "instance": name,
        "frag_nodes": be._frag_F,
        "batch_width": be.batch_width,
        "seconds": seconds,
        "points": int(front.points.shape[0]),
        "ips": int(front.ip_count),
        "waves": be.device_waves,
        "launches": launches["bb_fragment"],
        # K3's launches by cluster size and their lanes
        "cluster_sizes": dict(k3.cluster_sizes),
        "lanes_by_C": lanes_by_cluster(k3.launch_lanes),
        "clusters_held": dict(k3.held),
        "mean_lanes": fs["lanes"] / max(1, fs["waves"]),
        "records": fs["records"],
        "host_recs": fs["host_recs"],
        "host_rec_share": fs["host_recs"] / max(1, fs["records"]),
        "reopened": fs["reopened"],
        "ticks": fs["ticks"],
        "dev_iters": fs["dev_iters"],
        "ticked_out": fs["ticked_out"],
        "why": fs["why"],
        "court": fs.get("court"),
        "host_pruned": fs.get("host_pruned", 0),
        "rescue_lps": fs.get("rescue_lps", 0),
        "req_fallbacks": fs.get("req_fallbacks", 0),
        "verify_fallbacks": be.verify_fallbacks,
        "host_spans_seconds": spans,
        "golden": True,
    }
    emit(row)
    return row


def dp_problem(name, items, tmp):
    """The knapsack instance ``name``: bundled when ``items`` is None, else
    generated by the port's copy of the reference generator (seed 1)."""
    from moip_aira_tpu_torch.io import read_problem
    from moip_aira_tpu_torch.utils.generate import kp_lp

    if items is None:
        return read_problem(os.path.join(EXAMPLES, f"{name}.lp"))
    path = os.path.join(tmp, f"{name}.lp")
    with open(path, "w") as fh:
        fh.write(kp_lp(items, 2, seed=1))
    return read_problem(path)


def phase_dp_kernel(tmp):
    """K4 against dp_table_ref on the same CUDA items: the full final
    table equal bit for bit.  Returns the rows and each instance's front
    from the plain version's table."""
    import torch

    from moip_aira_tpu_torch.solver.cuda_dp import CudaKPDP
    from moip_aira_tpu_torch.solver.kp_front import (
        _extract_front, detect_kp2, dp_items, dp_table_ref, value_sum,
    )

    dev = torch.device("cuda", 0)
    rows, fronts = [], {}
    for name, n_gen in DP_INSTANCES:
        kp = detect_kp2(dp_problem(name, n_gen, tmp))
        if kp is None:
            raise AssertionError(f"{name}: not detected as a KP2")
        items = dp_items(kp, dev)
        cap, S = kp.cap, value_sum(kp)
        n = int(items.shape[1])
        dp = CudaKPDP()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        got = dp(items, cap, S)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        want, plain_ms = events_ms(lambda: dp_table_ref(items, cap, S))
        if not torch.equal(got, want):
            bad = torch.nonzero(got != want)[:5].tolist()
            raise AssertionError(
                f"K4 {name}: the final table differs from the plain "
                f"version's at (c, s) {bad}"
            )
        if dp.launches != n:
            raise AssertionError(f"K4 {name}: {dp.launches} launches for {n} items")
        fronts[name] = _extract_front(want[cap].cpu().numpy(), kp)
        del got, want
        ms = cuda_ms(lambda: dp(items, cap, S))
        bound_ms, bound_by = dp_bound(kp.table_cells, n)
        row = {
            "phase": "dp-kernel",
            "kernel": "kp_dp",
            "instance": name,
            "items": n,
            "cap": cap,
            "S": S,
            "table_cells": kp.table_cells,
            "table_mib": 4 * kp.table_cells / 2**20,
            "peak_mib": peak / 2**20,
            "points": int(fronts[name].shape[0]),
            "launches": n,
            "bitwise_equal": True,
            "max_abs_err": 0.0,
            "ms": ms,
            "ms_per_pass": ms / n,
            "plain_ms": plain_ms,
            "plain_ms_per_pass": plain_ms / n,
            "bound_ms": bound_ms,
            "bound_ms_per_pass": bound_ms / n,
            "bound_by": bound_by,
            "bound_share": bound_ms / ms,
        }
        emit(row)
        rows.append(row)
    return rows, fronts


def dp_front_run(name, p, dp, want):
    """One front through solve_front with ``dp``, the launch counts zeroed
    just before it and read just after: the golden (or reference) front,
    ip_count 0, K4 once per expanded item, K1-K3 never."""
    import numpy as np
    import torch

    from moip_aira_tpu_torch.api import solve_front
    from moip_aira_tpu_torch.solver.cuda_lp import LAUNCHES, reset_launches
    from moip_aira_tpu_torch.solver.kp_front import detect_kp2

    n_items = int(detect_kp2(p).w.shape[0])
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    front = solve_front(p, device="cuda", dp=dp)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    stats = front.backend_stats or {}
    if not np.array_equal(front.points, want):
        raise AssertionError(f"{name} (dp={dp}): the front differs from the reference")
    others = {k: v for k, v in launches.items() if k != "kp_dp"}
    if not (
        front.ip_count == 0
        and stats.get("backend") == "kp_front"
        and launches["kp_dp"] == n_items == stats.get("kernel_launches")
        and not any(others.values())
    ):
        raise AssertionError(
            f"{name} (dp={dp}): ip_count {front.ip_count}, stats {stats}, "
            f"launches {launches} (want the DP, K4 once per each of {n_items} "
            f"items, no other kernel)"
        )
    return front, seconds, launches["kp_dp"]


def nondominated(points):
    """The descending-lex front strictly decreasing in its first objective
    and strictly increasing in its second: no point dominates another."""
    import numpy as np

    return bool(
        np.all(np.diff(points[:, 0]) < 0) and np.all(np.diff(points[:, 1]) > 0)
    )


def phase_dp(tmp, plain_fronts):
    """The knapsack front DP through the port's entry points: the CLI with
    its defaults, solve_front with dp="on" and dp="auto"; then the DP
    against the AIRA engine at n = 50 and n = 100.  Returns the row of the
    2KP500 front, the main path of K4's kernel entry."""
    import numpy as np
    import torch

    from moip_aira_tpu_torch.api import solve_front
    from moip_aira_tpu_torch.io import read_problem
    from moip_aira_tpu_torch.solver.cuda_lp import LAUNCHES, reset_launches
    from moip_aira_tpu_torch.solver.kp_front import detect_kp2

    # dp="auto" follows the reference's rule, not an override from outside
    os.environ.pop("MOIP_DP", None)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")

    p100 = read_problem(os.path.join(EXAMPLES, "2KP100.lp"))
    out = os.path.join(tmp, "2KP100.out")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [
            sys.executable, "-m", "moip_aira_tpu_torch",
            "-p", os.path.join(EXAMPLES, "2KP100.lp"), "-o", out,
            "--device", "cuda", "--stats",
        ],
        cwd=REPO, env=env, capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"CLI failed on 2KP100 (exit {proc.returncode}):\n{proc.stderr[-4000:]}"
        )
    stats = next(
        (json.loads(line[len("[stats] "):]) for line in proc.stderr.splitlines()
         if line.startswith("[stats] {")),
        None,
    )
    if stats is None:
        raise RuntimeError("CLI printed no backend stats on 2KP100")
    if filtered(out) != filtered(os.path.join(EXAMPLES, "2KP100.out")):
        raise AssertionError("2KP100 (CLI): the front differs from the golden")
    ips = next(int(line.split()[0]) for line in open(out) if "IPs solved" in line)
    n100 = int(detect_kp2(p100).w.shape[0])
    if not (
        stats.get("backend") == "kp_front" and stats.get("kernel") == "kp_dp"
        and stats.get("kernel_launches") == stats.get("items") == n100 and ips == 0
    ):
        raise AssertionError(f"2KP100 (CLI): stats {stats}, {ips} IPs (want the DP on K4)")
    row = {
        "phase": "dp", "instance": "2KP100", "entry": "cli", "dp": "auto",
        "seconds": seconds, "ips": ips, "points": len(golden_front("2KP100")),
        "launches": stats["kernel_launches"], "items": stats["items"],
        "table_cells": stats["table_cells"], "golden": True,
    }
    emit(row)

    runs = (
        ("G2KP50", dp_problem("G2KP50", None, tmp), "on"),
        ("moip_2_30_knapsack",
         read_problem(os.path.join(EXAMPLES, "moip_2_30_knapsack.mop")), "on"),
        ("2KP500", dp_problem("2KP500", dict(DP_INSTANCES)["2KP500"], tmp), "auto"),
    )
    main = None
    for name, p, dp in runs:
        want = plain_fronts[name] if name == "2KP500" else golden_front(name)
        front, seconds, launches = dp_front_run(name, p, dp, want)
        if name == "2KP500" and not (front.points.shape[0] >= 2 and nondominated(front.points)):
            raise AssertionError(f"2KP500: {front.points.shape[0]} points, or a dominated one")
        row = {
            "phase": "dp", "instance": name, "entry": "solve_front", "dp": dp,
            "n": p.n, "seconds": seconds, "ips": int(front.ip_count),
            "points": int(front.points.shape[0]), "launches": launches,
            "items": front.backend_stats["items"],
            "table_cells": front.backend_stats["table_cells"],
            "reference": "plain version" if name == "2KP500" else "golden",
        }
        emit(row)
        if name == "2KP500":
            main = row

    # the n >= 80 rule of dp="auto": the DP on K4 against the AIRA engine
    # (kp_bb on the host), three runs each, in this process
    for name in ("G2KP50", "2KP100"):
        p = read_problem(os.path.join(EXAMPLES, f"{name}.lp"))
        want = golden_front(name)
        times = {"on": [], "off": []}
        for _ in range(3):
            for dp in ("on", "off"):
                if dp == "on":
                    _, seconds, _ = dp_front_run(name, p, dp, want)
                else:
                    reset_launches()
                    t0 = time.perf_counter()
                    front = solve_front(p, device="cuda", dp="off")
                    torch.cuda.synchronize()
                    seconds = time.perf_counter() - t0
                    if not np.array_equal(front.points, want) or any(LAUNCHES.values()):
                        raise AssertionError(f"{name} (dp=off): front or launches wrong")
                    if front.backend_stats.get("backend") != "kpbb":
                        raise AssertionError(f"{name} (dp=off): {front.backend_stats}")
                times[dp].append(seconds)
        row = {
            "phase": "dp", "instance": name, "entry": "threshold", "n": p.n,
            "dp_seconds": times["on"], "aira_seconds": times["off"],
            "dp_median": sorted(times["on"])[1], "aira_median": sorted(times["off"])[1],
        }
        emit(row)
    return main


def lex_batch(p, lanes):
    """The initial rhs under both orderings, then golden points under the
    identity and the reversed ordering in turn."""
    import numpy as np

    k = p.objcnt
    ident, rev = list(range(k)), list(range(k))[::-1]
    name = os.path.splitext(os.path.basename(p.filename))[0]
    gold = golden_front(name).astype(np.float64)
    rhs, perm = [p.initial_rhs(), p.initial_rhs()], [ident, rev]
    i = 0
    while len(rhs) < lanes:
        rhs.append(gold[i % len(gold)])
        perm.append(ident if (i // len(gold)) % 2 == 0 else rev)
        i += 1
    return np.array(rhs), np.array(perm)


def phase_lex():
    """The lex backend (``backend="jax"``: solver/lex_torch.py, plain
    PyTorch in f64, no kernel of K1-K4) on the card: three fronts against
    their goldens and IPs, then one batch of the lex kernel at 2AP20 held
    against the same call on the CPU."""
    import numpy as np
    import torch

    from moip_aira_tpu_torch.api import solve_front
    from moip_aira_tpu_torch.io import read_problem
    from moip_aira_tpu_torch.solver.cuda_lp import LAUNCHES, reset_launches
    from moip_aira_tpu_torch.solver.lex_torch import (
        LEX_RESOURCE, TorchLexBackend, make_lex_kernel,
    )

    smi = card()
    rows = []
    for name, want_ips in LEX_FRONTS:
        p = read_problem(os.path.join(EXAMPLES, f"{name}.lp"))
        be = TorchLexBackend(p, device="cuda")
        if not be.kernel.lp.W.is_cuda:
            raise AssertionError(f"{name}: the lex kernel's system is not on the card")
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        front = solve_front(p, n_workers=2, backend=be, device="cuda", dp="off")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        if not np.array_equal(front.points, golden_front(name)):
            raise AssertionError(f"{name}: the lex front differs from the golden")
        if front.ip_count != want_ips:
            raise AssertionError(f"{name}: {front.ip_count} IPs, want {want_ips}")
        if any(launches.values()):
            raise AssertionError(f"{name}: the lex path launched {launches}")
        if be.fallback_count > MAX_FALLBACK_SHARE * be.lanes:
            raise AssertionError(
                f"{name}: {be.fallback_count} of {be.lanes} lanes fell back "
                f"(limit {MAX_FALLBACK_SHARE:.0%})"
            )
        row = {
            "phase": "lex", "instance": name, "entry": "solve_front",
            "seconds": seconds, "points": int(front.points.shape[0]),
            "ips": int(front.ip_count), "rounds": front.rounds,
            "device_batches": be.device_batches, "lanes": be.lanes,
            "fallback_count": be.fallback_count, "bnb_steps": be.bnb_steps,
            "lp_steps": be.lp_steps, "host_syncs": be.host_syncs,
            "us_per_lp_step": seconds / max(1, be.lp_steps) * 1e6,
            "golden": True, "card": smi,
        }
        emit(row)
        rows.append(row)

    name, lanes = LEX_BATCH
    p = read_problem(os.path.join(EXAMPLES, f"{name}.lp"))
    rhs, perm = lex_batch(p, lanes)
    outs, times, kerns = {}, {}, {}
    for dev in ("cuda", "cpu"):
        kern = make_lex_kernel(p, device=dev)
        if dev == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = kern(rhs, perm)
        if dev == "cuda":
            if not all(t.is_cuda for t in out):
                raise AssertionError("the lex kernel's results left the card")
            torch.cuda.synchronize()
        times[dev] = time.perf_counter() - t0
        outs[dev] = [t.cpu().numpy() for t in out]
        kerns[dev] = kern
    if not all(np.array_equal(a, b) for a, b in zip(outs["cuda"], outs["cpu"])):
        raise AssertionError(f"{name}: the lex kernel on the card differs from the CPU")
    status = outs["cuda"][0]
    resource = int((status == LEX_RESOURCE).sum())
    if resource > MAX_FALLBACK_SHARE * lanes:
        raise AssertionError(f"{name}: {resource} of {lanes} lanes would fall back")
    kern = kerns["cuda"]
    row = {
        "phase": "lex", "instance": name, "entry": "make_lex_kernel", "lanes": lanes,
        "seconds": times["cuda"], "cpu_seconds": times["cpu"],
        "status_counts": np.bincount(status, minlength=4).tolist(),
        "ips": int(outs["cuda"][2].sum()), "fallback_lanes": resource,
        "bnb_steps": kern.bnb_steps, "lp_steps": kern.lp_steps,
        "host_syncs": kern.host_syncs,
        "us_per_lp_step": times["cuda"] / max(1, kern.lp_steps) * 1e6,
        "cpu_us_per_lp_step": times["cpu"] / max(1, kerns["cpu"].lp_steps) * 1e6,
        "equal_to_cpu": True, "card": smi,
    }
    emit(row)
    rows.append(row)
    return rows


def phase_mesh():
    """The twin of ``__graft_entry__.dryrun_multichip``: G3AP05, 6 workers,
    the wave backend, ``mesh_devices=8`` on the card (one domain on a
    one-card machine), with the reference's counts on one device; then the
    distributed round of the lex kernel on G2AP05."""
    import numpy as np
    import torch

    from moip_aira_tpu_torch.api import solve_front
    from moip_aira_tpu_torch.io import read_problem
    from moip_aira_tpu_torch.parallel.mesh import make_distributed_round, make_mesh
    from moip_aira_tpu_torch.solver.cuda_lp import LAUNCHES, reset_launches

    smi = card()
    p = read_problem(os.path.join(EXAMPLES, "G3AP05.lp"))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    front = solve_front(p, n_workers=6, backend="wave", device="cuda", mesh_devices=8, dp="off")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    stats = front.backend_stats
    if not np.array_equal(front.points, golden_front("G3AP05")):
        raise AssertionError("mesh: the G3AP05 front differs from the golden")
    got = (front.ip_count, front.rounds, front.domain_ips, front.pre_ips)
    if got != (111, 8, [68], 43):
        raise AssertionError(f"mesh: (IPs, rounds, domain_ips, pre_ips) {got}")
    k1 = launches["dense_simplex"]
    if not (k1 > 0 and k1 == stats["device_waves"]) or any(
        v for k, v in launches.items() if k != "dense_simplex"
    ):
        raise AssertionError(f"mesh: launches {launches} over {stats['device_waves']} waves")
    emit({
        "phase": "mesh", "instance": "G3AP05", "entry": "solve_front",
        "seconds": seconds, "ips": front.ip_count, "rounds": front.rounds,
        "domain_ips": front.domain_ips, "pre_ips": front.pre_ips,
        "mesh": stats["mesh"], "waves": stats["device_waves"],
        "launches": k1, "golden": True, "card": smi,
    })

    p = read_problem(os.path.join(EXAMPLES, "G2AP05.lp"))
    mesh = make_mesh(8)
    step, B = make_distributed_round(p, mesh)
    k = p.objcnt
    perms = [list(range(k)), list(range(k))[::-1]]
    rhs = np.tile(p.initial_rhs(), (B, 1))
    perm = np.array([perms[i % 2] for i in range(B)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = step(rhs, perm)
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    if not all(t.is_cuda for t in out):
        raise AssertionError("mesh: the distributed round's results left the card")
    status, results, all_status, lo, hi = (t.cpu().numpy() for t in out)
    gold = golden_front("G2AP05")
    if not ((status == 0).all() and (all_status == 0).all()):
        raise AssertionError(f"mesh: round statuses {status.tolist()}")
    if {tuple(r) for r in results} != {tuple(gold[0]), tuple(gold[-1])}:
        raise AssertionError(f"mesh: round results {results.tolist()}")
    if lo[0].tolist() != gold.min(0).tolist() or hi[0].tolist() != gold.max(0).tolist():
        raise AssertionError(f"mesh: lo {lo.tolist()} hi {hi.tolist()}")
    emit({
        "phase": "mesh", "instance": "G2AP05", "entry": "make_distributed_round",
        "mesh_shape": mesh.shape, "lanes": B, "seconds": round_s,
        "results": results.tolist(), "lo": lo[0].tolist(), "hi": hi[0].tolist(),
        "card": smi,
    })


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the kernel phase's LP lanes (default 0)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    if not os.path.isdir(os.path.join(REPO, "moip_aira_tpu_torch")):
        raise SystemExit("chip_smoke: run it from a checkout of the repository")
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    if shutil.which("nvidia-smi") is None:
        raise SystemExit("chip_smoke: nvidia-smi not found")

    phase_probe()
    phase_build()
    k1_rows = phase_kernels(args.seed)
    k2_rows = phase_revised(args.seed)
    phase_crossover(args.seed)
    cli = phase_cli()
    real = phase_front("real", "2AP20", "dense_simplex")
    # K1 at the lanes a launch of each of its fronts had on average
    front_lanes = {"2AP20": max(1, round(real["mean_lanes"]))}
    for r in cli:
        if r["instance"] in ("G3KP10", "KP2D50"):
            front_lanes[r["instance"]] = max(1, round(r["mean_lanes"]))
    k1_rows += phase_kernels_front(args.seed, front_lanes)
    wide = phase_front("wide", "2AP40", "revised_simplex")
    frag = phase_frag_front("frag", "2AP20", 1)
    phase_frag_front("frag3", "G3AP05", 2)
    phase_frag_front("frag3", "G3KP10", 1, frag_nodes=2)
    frag_wide = phase_frag_front("frag-wide", "2AP40", 1)
    # K3 at the lanes a launch of each front had on average
    k3_rows = phase_fragment(args.seed, {
        "2AP20": round(frag["mean_lanes"]), "2AP40": round(frag_wide["mean_lanes"]),
    })
    with tempfile.TemporaryDirectory() as tmp:
        k4_rows, plain_fronts = phase_dp_kernel(tmp)
        dp_main = phase_dp(tmp, plain_fronts)
    phase_lex()
    phase_mesh()
    if "jax" in sys.modules or "moip_aira_tpu" in sys.modules:
        raise AssertionError("the port imported jax or the JAX package")

    def entry(name, replaces, rows, main, shape):
        row = next(
            r for r in rows
            if r["instance"] == shape and r["start"] == "cold" and r["lanes"] == LANES
        )
        # no single PyTorch call computes a batched simplex or a B&B subtree
        return {
            "name": name,
            "route": "cuda",
            "source": f"moip_aira_tpu_torch/csrc/{name}.cu",
            "replaces": replaces,
            "launches": main["launches"],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,
        }

    def dp_entry(rows, main):
        # one item pass of K4 at 2KP500, like the other entries' one
        # launch; no single PyTorch call computes one DP item step (a
        # shifted read, a masked add and a max over two tables)
        row = next(r for r in rows if r["instance"] == main["instance"])
        return {
            "name": "kp_dp",
            "route": "cuda",
            "source": "moip_aira_tpu_torch/csrc/kp_dp.cu",
            "replaces": "moip_aira_tpu/solver/kp_front.py:296",
            "launches": main["launches"],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": row["ms_per_pass"],
            "plain_ms": row["plain_ms_per_pass"],
            "bound_ms": row["bound_ms_per_pass"],
            "bound_by": row["bound_by"],
            "library_ms": None,
        }

    emit({
        "kernels": [
            entry("dense_simplex", "moip_aira_tpu/solver/pallas_lp.py:116",
                  k1_rows, real, "2AP20"),
            entry("revised_simplex", "moip_aira_tpu/solver/pallas_rev.py:102",
                  k2_rows, wide, "2AP40"),
            entry("bb_fragment", "moip_aira_tpu/solver/pallas_bb.py:211",
                  k3_rows, frag, "2AP20"),
            dp_entry(k4_rows, dp_main),
        ]
    })
    emit({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())

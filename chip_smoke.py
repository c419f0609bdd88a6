#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (moip_aira_tpu_torch) on one GPU.

Drives the port's main paths on the card — read_problem -> solve_front ->
bound sweep (k=2) or AIRA scheduler (k>=3) -> WaveLexBackend -> the
hand-written CUDA kernels, K1 (dense tableau, LPs of n + m < 512 columns)
and K2 (revised simplex, wider LPs) on the per-LP path, K3 (B&B fragments,
a subtree per lane) on the fragment path -> f64 certification and audit ->
host branch and bound; read_problem -> solve_front -> the knapsack front
DP, K4 (one launch per item) for single-capacity bi-objective knapsacks;
K5 (the dense simplex loop of solver/simplex_dense.py) under the wave's
XLA engine; and K6 (the lex backend's whole batch, K5's loop at every B&B
node, one launch a batch) — and fails unless every phase passes:

1. probe:     the card (nvidia-smi), torch, CUDA and nvcc versions;
2. build:     K1 (csrc/dense_simplex.cu), K2 (csrc/revised_simplex.cu),
              K3 (csrc/bb_fragment.cu), K4 (csrc/kp_dp.cu), K5
              (csrc/simplex_dense.cu) and K6 (csrc/lex_bnb.cu), one nvcc
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
15. dense-loop: K5 against its plain version, DenseLPSolver on the CPU:
              first that the CPU's addcmul (the plain version's fused
              multiply-add) rounds once, else the phase fails; then the
              same numpy-made lanes on both, float32 (the XLA engine's
              tolerances) and float64, at G3KP10, KP2D50 and G2AP05 (64
              lanes), 2AP20 (32), 2AP40 (256) and 2AP60 (8: its tableau
              slice fits no block of a cluster of 8), and float64 at the lex
              backend's 2AP20 batch (its root LPs), each in every plan that
              fits (a warp a lane at P = 1, 2, 4 and 8 lanes a block, a
              block, a cluster of each size C whose slices fit, a cluster
              of each size with its slices in global memory) beside the
              one K5's plan picks: status, objective, x, basis, at-upper
              flags and iterations equal bit for bit on every lane; each
              row with its shape, C, P, threads and layout, ms (CUDA
              events, median of 5), the plain version's ms (one run), the
              bound (from the plain run's steps and pivots) and us a step;
16. lex:      the lex backend (backend="jax", solver/lex_torch.py: on the
              card each batch one launch of K6, every stage's B&B and every
              node's LP inside it, f64) on the card: G2AP05 (the sweep),
              G3AP05 and G3KP10 with n_workers=2 against their goldens and
              IPs (24 / 57 / 109) and the CPU's totals of the lanes' nodes
              and LP steps (LEX_FRONTS), with K6 launched once a batch and
              no other kernel; then one call of the lex kernel on G3KP10's
              32 lanes (regs, then forced onto packed), on 3AP10's 18
              (LEX_AP_BATCH: regs_block, then packed) and on 2AP20's
              32 lanes (the initial rhs and golden points under both
              orderings), each one's statuses, results, IPs and each lane's nodes
              and LP steps must equal the same call's on the CPU, K6 timed
              on it (CUDA events, median of 5) beside the plain version
              (one run) and its bound (lex_bound); each row with seconds,
              batches, lanes, fallbacks, nodes, LP steps, the critical
              path, host syncs, K6's launches and plans; at most
              MAX_FALLBACK_SHARE of lanes may fall back;
17. mesh:     the twin of __graft_entry__.dryrun_multichip: G3AP05, 6
              workers, the wave backend with mesh_devices=8 on the card
              (one domain on a one-card machine), with K1 on every wave and
              the counts of the reference on one device (111 IPs, 8 rounds,
              domain_ips [68], pre_ips 43); then the distributed round of
              the lex kernel on G2AP05 (statuses 0, the front's two ends,
              their min and max; one K6 launch a card);
18. mesh-devices: the wave over a mesh of several devices (solve_front
              with mesh_devices through the mesh scheduler; one kernel
              wrapper per device, each wave's lanes split over the devices
              in proportion to their domains): G3AP05, 6 workers, 8 domains
              alternating over the card and the host CPU, per-LP (K1 on the
              card, its plain version on the CPU) and fragments (K3 and
              its plain version), each with the reference's counts on 8
              devices (118 IPs, 10 rounds, domain_ips [19, 13, 7, 14, 13,
              9], pre_ips 43), the golden front, lanes on both devices and
              K1 (K3) launched on the card once a wave; the G3KP10 front on
              K1 over a two-domain mesh of the card and the CPU against its
              golden; then, where two or more cards are visible, the 2AP40
              front (K2) and the 2AP20 fragment front (K3) over a mesh of
              the cards, one domain a card, each against its golden and
              with the counts of the same mesh on one card, with lanes and
              launches on every card and the host spans
              wave.device_lp / frag.device_exec of both; with one card, a
              line that says the cross-card fronts were not run;
19. xla:      the wave's XLA engine (WaveLexBackend(engine="xla"):
              solver/xla_lp.py, the reference's XLA engine, K5 one launch a
              wave) on the card: the G2AP05, G3KP10 and 2AP20 fronts in
              float32 and G3AP05 in float64 at `real`'s widths, each
              against its golden and the CPU's waves, LPs, re-solves and
              LP steps (XLA_CPU_COUNTS), with K5 launched once a wave and
              no other kernel; seconds, host syncs and us a step beside
              K1's for the same front from phases cli and real; then the
              256 cold 2AP20 lanes of phase kernels and the 256 cold 2AP40
              lanes of phase revised through the engine, timed by CUDA
              events (median of 5) beside K1's and K2's times on the same
              lanes, and the first XLA_CPU_LANES 2AP20 lanes bit for bit
              against the same call on the CPU.

Each phase prints one JSON line (phases 15-19 with the card's name and
power limit).  The last two lines are the kernel table
({"kernels": [...]}) and {"ok": true, "device": {...}}.  Any failure raises
and the exit code is not 0.  Run from the root of a checkout:

    python3 chip_smoke.py [--seed N]

``--only mesh-devices`` runs phases 1, 2 and 18 alone (no kernel table),
to try the multi-device wave on a machine with several cards; ``--only
xla``, ``--only dense-loop`` and ``--only lex`` run phases 1, 2 and that
phase alone (xla without K1's and K2's figures).
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
KERNELS = ("dense_simplex", "revised_simplex", "bb_fragment", "kp_dp", "simplex_dense",
           "lex_bnb")
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
# float64 operations per second outside the tensor cores (H100 SXM data
# sheet: 34 TFLOP/s)
PEAK_F64_PER_S = 34e12
# int32 operations per second outside the tensor cores: 64 INT32 lanes an SM
# against 128 FP32 lanes (Hopper white paper), so half the float32 lane rate,
# 132 SMs x 64 x 1.98 GHz
PEAK_I32_PER_S = 16.7e12
OBJ_RTOL = 1e-3  # f32 objectives of two pivot paths (tests/test_simplex.py)
CERT_RTOL = 1e-7  # certified f64 optima of the same LP from two bases
# at most this share of a front's device LPs may fail f64 certification and
# be re-solved on the host (the H100 runs re-solve 0-0.16%)
MAX_FALLBACK_SHARE = 0.05
#: the lex backend's fronts (backend="jax", n_workers=2): their IPs, and
#: the lanes' B&B nodes and LP steps summed over the same front on the CPU
#: (`python3 tools/lex_bench.py --cpu-fronts`, torch 2.13.0+cpu), which
#: K6 must repeat; its fronts and the lex kernel's batch fail past
#: MAX_FALLBACK_SHARE of their lanes re-solved on the host
LEX_FRONTS = (
    ("G2AP05", 24, 274, 5514),
    ("G3AP05", 57, 471, 9637),
    ("G3KP10", 109, 22629, 326282),
)
#: the lex kernel's batch at full width: 2AP20 (n = 400, m = 42, an f64
#: tableau of 42 x 442 a lane), the reference backend's 32 lanes
LEX_BATCH = ("2AP20", 32)
#: the lex kernel's batch at the fronts' shape: G3KP10's 32 lanes (n = 10,
#: m = 4), on K6's ``regs`` plan, the one its fronts and the mesh round
#: launch, and forced onto K5's ``packed`` plan
LEX_PACKED_BATCH = ("G3KP10", 32)
#: the lex kernel's batch at the assignment cell's shape: 3AP10 (n = 100,
#: m = 23, 23 x 123 LPs; ``ap_case``), 18 lanes (the benchmark's
#: ``3ap10-lex-split32`` launches 18.07 a batch), on K6's ``regs_block``
#: plan and forced onto K5's ``packed``
LEX_AP_BATCH = ("3AP10", 18)
#: the XLA engine's fronts at `real`'s widths: (instance, dtype, n_workers,
#: the phase whose K1 front it stands beside)
XLA_FRONTS = (
    ("G2AP05", "float32", 2, "cli"),
    ("G3KP10", "float32", 2, "cli"),
    ("2AP20", "float32", 1, "real"),
    ("G3AP05", "float64", 2, "cli"),
)
#: a front whose CPU run already re-solves more than MAX_FALLBACK_SHARE of
#: its LPs on the host is held to twice its CPU share (none so far)
XLA_FALLBACK_SHARE: dict = {}
#: the XLA engine's fronts on the CPU at the same widths (`python3
#: tools/xla_parity.py --cpu-counts`, torch 2.13.0+cpu): device waves, LPs,
#: re-solves and LP steps, which the card must repeat
XLA_CPU_COUNTS = {
    ("G2AP05", "float32"): (19, 98, 0, 592),
    ("G3KP10", "float32"): (603, 16343, 33, 14309),
    ("2AP20", "float32"): (33, 1192, 8, 43637),
    ("G3AP05", "float64"): (81, 269, 0, 2440),
}
#: K5 in phase dense-loop: (instance, lanes) in float32 and float64, the
#: XLA engine's shapes (2AP40's tableau split over a cluster, 2AP60's over
#: a cluster in global memory), then the lex backend's 2AP20 batch
#: (LEX_BATCH) in float64
DENSE_LOOP_SHAPES = (("G3KP10", 64), ("KP2D50", 64), ("G2AP05", 64), ("2AP20", 32),
                     ("2AP40", 256), ("2AP60", 8))
#: the shapes and lengths of the CPU addcmul check (the plain version's
#: fused multiply-adds)
FMA_CHECK_LENGTHS = (14, 37, 442, 1682)
#: the XLA engine's batches: (instance, the seed offset of the phase whose
#: 256 cold lanes it takes: kernels 0, revised 1, and that phase's kernel)
XLA_BATCHES = (("2AP20", 0, "dense_simplex"), ("2AP40", 1, "revised_simplex"))
#: the first this many 2AP20 lanes also run on the CPU
XLA_CPU_LANES = 32


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
    from moip_aira_tpu_torch.utils.trace import GLOBAL_TIMINGS, recording

    p = read_problem(os.path.join(EXAMPLES, f"{name}.lp"))
    be = WaveLexBackend(
        p, device="cuda", fragments=False, batch_width=2048, nodes_per_task=32
    )
    spans0 = dict(GLOBAL_TIMINGS.totals)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with recording():
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
    from moip_aira_tpu_torch.utils.trace import GLOBAL_TIMINGS, recording

    p = read_problem(os.path.join(EXAMPLES, f"{name}.lp"))
    be = WaveLexBackend(p, device="cuda", fragments=True, **kw)
    spans0 = dict(GLOBAL_TIMINGS.totals)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with recording():
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


def cpu_addcmul_fused():
    """Whether PyTorch's CPU ``addcmul``, which the plain version of K5
    uses for its fused multiply-adds, rounds once: on 64 x L random float32
    triples it must equal the product and sum done in float64 and rounded
    once on every element (the rounded product plus the sum does so on
    about three quarters), and in float64, at value 1 and -1, the exact
    c +- a b rounded once on a sample.  Returns the shares."""
    from fractions import Fraction

    import numpy as np
    import torch

    rng = np.random.default_rng(11)
    shares = {}
    for L in FMA_CHECK_LENGTHS:
        a, b, c = (torch.as_tensor(rng.standard_normal((64, L)), dtype=torch.float32)
                   for _ in range(3))
        got = torch.addcmul(c, a, b)
        once = (c.double() + a.double() * b.double()).float()
        shares[f"f32 L={L}"] = [float((got == once).float().mean()),
                                float((got == c + a * b).float().mean())]
        a, b, c = (torch.as_tensor(rng.standard_normal((4, L))) for _ in range(3))
        for value in (1.0, -1.0):
            got = torch.addcmul(c, a, b, value=value)
            same = [
                got[i, j].item() == float(
                    Fraction(c[i, j].item()) + Fraction(value) * Fraction(a[i, j].item())
                    * Fraction(b[i, j].item()))
                for i in range(4) for j in range(0, L, max(1, L // 50))
            ]
            shares[f"f64 L={L} value={value:+.0f}"] = [sum(same) / len(same)]
    fused = all(v[0] == 1.0 for v in shares.values())
    return fused, shares


def dense_bound(m, n, iters, pivots, dsize):
    """The least time the card could take for one K5 launch on these
    lanes, in ms, and what sets it.  Bytes: W and each lane's c, lo, hi
    read once, its status, objective, x, basis (int64), at-upper bytes and
    iterations written once.  Operations: 2 m (n + m) a step for pricing,
    at each lane's own steps (``iters``), and 2 m (n + m) more a pivot for
    the rank-1 update, at each lane's own pivots (a bound flip and the
    last, pricing-only step update nothing), over the card's float32 or
    float64 rate."""
    import numpy as np

    nc = n + m
    B = len(iters)
    nbytes = dsize * (m * nc + B * 3 * nc + B * (1 + n)) + B * (4 + 4 + 8 * m + nc)
    ops = (float(np.sum(iters)) + float(np.sum(pivots))) * 2 * m * nc
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / (PEAK_F64_PER_S if dsize == 8 else PEAK_F32_PER_S)
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def lex_root_lanes(p, rhs, perm):
    """The lex kernel's first LP call on the lanes (rhs, perm): the stage-0
    objective of each lane over the root box, its objective rows bounded
    by the rhs (solver/lex_torch.py ``_bnb``), as float64 arrays."""
    import numpy as np

    from moip_aira_tpu_torch import Sense

    n, m = p.n, p.m_total
    is_min = p.objsen is Sense.MIN
    free = np.full(rhs.shape, np.inf)
    olo, ohi = (-free, rhs) if is_min else (rhs, free)
    B = rhs.shape[0]
    c = np.zeros((B, n + m))
    c[:, :n] = (1.0 if is_min else -1.0) * p.C[perm[:, 0]]
    lo = np.hstack([np.tile(np.concatenate([p.lb, p.row_lb]), (B, 1)), olo])
    hi = np.hstack([np.tile(np.concatenate([p.ub, p.row_ub]), (B, 1)), ohi])
    return c, lo, hi


def phase_dense_loop(seed):
    """K5 against its plain version, DenseLPSolver on the CPU, on the same
    numpy-made lanes: first that the CPU's addcmul is fused (else the plain
    version is not what K5 computes), then float32 (the XLA engine's
    tolerances) and float64 at DENSE_LOOP_SHAPES, and float64 at the lex
    backend's 2AP20 batch, each in every plan that fits (a warp a lane at
    P = 1, 2, 4 and 8, a block, each cluster size, with the tableau in
    shared and in global memory; ``cuda_dense.loop_plans``)
    as well as the one K5's plan picks; every output of every lane equal
    bit for bit.  Each row: the plan (shape, C, P, threads, layout, whether
    it is the pick), ms (CUDA events, median of 5), the plain version's ms
    (one run), the bound, pivots and us a step."""
    import numpy as np
    import torch

    from moip_aira_tpu_torch.io import read_problem
    from moip_aira_tpu_torch.solver.cuda_dense import (
        launch_dense_loop, loop_plan, loop_plans, max_clusters,
    )
    from moip_aira_tpu_torch.solver.simplex_dense import DenseLPSolver
    from moip_aira_tpu_torch.solver.xla_lp import F32_TOLERANCES

    smi = card()
    fused, shares = cpu_addcmul_fused()
    emit({"phase": "dense-loop", "check": "cpu addcmul rounds once", "fused": fused,
          "shares_equal_once_and_rounded_twice": shares, "torch": torch.__version__})
    if not fused:
        raise AssertionError(f"dense-loop: the CPU addcmul is not fused: {shares}")
    dev = torch.device("cuda", 0)
    cases = []
    for dtype in (torch.float32, torch.float64):
        for name, lanes in DENSE_LOOP_SHAPES:
            p = read_problem(os.path.join(EXAMPLES, f"{name}.lp"))
            rng = np.random.default_rng(seed + 2)
            cases.append((name, "wave lanes", dtype, p, _lanes(p, rng, golden_front(name), lanes)))
    name, lanes = LEX_BATCH
    p = read_problem(os.path.join(EXAMPLES, f"{name}.lp"))
    cases.append((name, "lex batch, root LPs", torch.float64, p,
                  lex_root_lanes(p, *lex_batch(p, lanes))))
    rows = []
    for name, kind, dtype, p, (c, lo, hi) in cases:
        m, n = p.m_total, p.n
        W = np.hstack([np.vstack([p.A, p.C]), -np.eye(m)])
        tol = F32_TOLERANCES if dtype == torch.float32 else {}
        plain = DenseLPSolver(torch.as_tensor(W, dtype=dtype), 2000, **tol)
        args = [torch.as_tensor(a, dtype=dtype) for a in (c, lo, hi)]
        t0 = time.perf_counter()
        want = plain(*args)
        plain_s = time.perf_counter() - t0
        W_dev = torch.as_tensor(W, dtype=dtype, device=dev)
        args_dev = [a.to(dev) for a in args]
        iters = want.iters.numpy()
        # the pivots of the plain run, whose every output K5 equals
        pivots = plain.pivots.numpy()
        dsize = 8 if dtype == torch.float64 else 4
        bound_ms, bound_by = dense_bound(m, n, iters, pivots, dsize)
        chosen = loop_plan(W_dev, len(iters))
        plans = loop_plans(W_dev)
        if chosen not in plans:
            raise AssertionError(f"dense-loop {name}: the pick {chosen} is not among {plans}")
        for plan in plans:

            def k5(plan=plan):
                return launch_dense_loop(
                    W_dev, *args_dev, None, plain.max_iters, plain.feas_tol, plain.cost_tol,
                    plain.pivot_tol, plain.progress_tol, plain.stall_limit, plan=plan,
                )

            got = k5()
            torch.cuda.synchronize()
            got_cpu = type(got)(*(t.cpu() for t in got))
            label = (f"dense-loop {name} ({kind}, {str(dtype)[6:]}, {plan.shape} "
                     f"C={plan.C} P={plan.P})")
            assert_bitwise(label, got_cpu, want)
            ms = cuda_ms(k5)
            err = max(float((got_cpu.obj - want.obj).abs().max()),
                      float((got_cpu.x - want.x).abs().max()))
            row = {
                "phase": "dense-loop", "instance": name, "lanes": len(iters), "kind": kind,
                "dtype": str(dtype)[6:], "m": m, "nc": n + m, "shape": plan.shape,
                "C": plan.C, "P": plan.P, "threads": plan.threads, "layout": plan.layout,
                "smem_bytes": plan.smem_bytes, "held": max_clusters(0, plan),
                "chosen": plan == chosen,
                "ms": ms, "plain_ms": 1e3 * plain_s, "bound_ms": bound_ms, "bound_by": bound_by,
                "max_iters": int(iters.max()), "mean_iters": float(iters.mean()),
                "steps": int(iters.sum()), "pivots": int(pivots.sum()),
                "us_per_step": 1e3 * ms / max(1, int(iters.max())),
                "status_counts": np.bincount(want.status.numpy(), minlength=4).tolist(),
                "max_abs_err": err, "bitwise_equal": True, "card": smi,
            }
            emit(row)
            rows.append(row)
    return rows


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


def ap_case(lanes, seed=3):
    """3AP10 (``utils.generate.ap_lp(10, 3, 1)``, the benchmark's
    ``kirlik-3ap-n10`` seed 1) and ``lanes`` lex requests: the initial rhs,
    then rhs that bound each objective between 30 and 89 or (0.4) leave it
    free, each under a random ordering."""
    import tempfile

    import numpy as np

    from moip_aira_tpu_torch.io import read_problem
    from moip_aira_tpu_torch.utils.generate import ap_lp

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "3AP10.lp")
        with open(path, "w") as fh:
            fh.write(ap_lp(10, 3, 1))
        p = read_problem(path)
    rng = np.random.default_rng(seed)
    rhs = np.array([
        p.initial_rhs() if b == 0
        else np.where(rng.random(3) < 0.4, np.inf, rng.integers(30, 90, size=3))
        for b in range(lanes)
    ])
    perm = np.array([rng.permutation(3) for _ in range(lanes)])
    return p, rhs, perm


def lex_bound(m, n, k, nodes, iters, pivots):
    """The least time the card could take for one K6 launch on these
    lanes, in ms, and what sets it.  Bytes: W, each lane's rhs and perm,
    the objectives and bounds read once, each lane's status, results, IPs,
    nodes and LP steps written once.  Operations, as ``dense_bound`` counts
    a K5 row, from the plain run's per-lane counts: 2 m (n + m) a node for
    its start (the basic values), a step for pricing and a pivot for the
    rank-1 update, over the card's float64 rate."""
    import numpy as np

    nc = n + m
    B = len(nodes)
    nbytes = 8 * (m * nc + 2 * B * k + k * n + 2 * n + 2 * (m - k)) + n + k \
        + B * (4 + 8 * k + 4 + 8 + 8)
    work = float(np.sum(nodes)) + float(np.sum(iters)) + float(np.sum(pivots))
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = work * 2 * m * nc / PEAK_F64_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def lex_batch_row(name, lanes, want_shape, smi, force=None):
    """One call of the lex kernel on ``lex_batch``'s lanes of ``name``
    (3AP10: ``ap_case``'s) on the card (one K6 launch, in the plan
    ``want_shape`` when given; with ``force``, a shape of K6's plans for
    the shape, its plan of four lanes a block) and on the CPU, held lane by
    lane: status, results, IPs, nodes and LP steps; then K6 timed beside
    its plain version and its bound.  Returns the row and the largest
    difference (0)."""
    import numpy as np
    import torch

    from moip_aira_tpu_torch.io import read_problem
    from moip_aira_tpu_torch.solver.cuda_dense import K5_PACK_LANES
    from moip_aira_tpu_torch.solver.cuda_lex import launch_lex_bnb, lex_plans
    from moip_aira_tpu_torch.solver import lex_torch as lt
    from moip_aira_tpu_torch.solver.cuda_lp import LAUNCHES
    from moip_aira_tpu_torch.solver.lex_torch import LEX_RESOURCE, make_lex_kernel

    if name == LEX_AP_BATCH[0]:
        p, rhs, perm = ap_case(lanes)
    else:
        p = read_problem(os.path.join(EXAMPLES, f"{name}.lp"))
        rhs, perm = lex_batch(p, lanes)
    outs, times, kerns, calls = {}, {}, {}, {}
    for dev in ("cuda", "cpu"):
        kern = make_lex_kernel(p, device=dev)

        def call(kern=kern):
            # the kernel's call: status, results, IPs, then each lane's nodes
            # and LP steps
            out = kern(rhs, perm)
            return [*out, kern.lane_nodes, kern.lane_iters]

        if dev == "cuda":
            torch.cuda.synchronize()
            k5, k6 = LAUNCHES["simplex_dense"], LAUNCHES["lex_bnb"]
            if force is not None:
                forced = next(q for q in lex_plans(kern.W)
                              if q.shape == force and q.P == K5_PACK_LANES)
                lanes_t = [torch.as_tensor(a, device="cuda") for a in (rhs, perm)]

                def call(kern=kern, lanes_t=lanes_t, forced=forced):
                    # LexKernel._launch's call, on the forced plan, recorded
                    # by the wrapper in the kernel's plan_launches
                    out = launch_lex_bnb(
                        kern.W, *lanes_t, kern.C, kern.lb, kern.ub, kern.row_lb,
                        kern.row_ub, kern.is_int, kern.obj_integral, kern.is_min, kern.maxn,
                        kern.max_bnb_nodes, kern.lp_max_iters, lt.FEAS_TOL, lt.COST_TOL,
                        lt.PIVOT_TOL, lt.PROGRESS_TOL, lt.STALL_LIMIT, plan=forced,
                        plan_launches=kern.plan_launches,
                    )
                    return list(out)
        calls[dev] = call
        t0 = time.perf_counter()
        out = call()
        if dev == "cuda":
            if not all(t.is_cuda for t in out):
                raise AssertionError("the lex kernel's results left the card")
            torch.cuda.synchronize()
            k5 = LAUNCHES["simplex_dense"] - k5
            k6 = LAUNCHES["lex_bnb"] - k6
            launched = dict(kern.plan_launches)
        times[dev] = time.perf_counter() - t0
        outs[dev] = [t.cpu().numpy() for t in out]
        kerns[dev] = kern
    for a, b, what in zip(outs["cuda"], outs["cpu"],
                          ("status", "results", "ips", "nodes", "iters")):
        if not np.array_equal(a, b):
            bad = np.nonzero((a != b).reshape(len(a), -1).any(1))[0][:10].tolist()
            raise AssertionError(f"{name}: the lex kernel's {what} on the card differ from "
                                 f"the CPU's on lanes {bad}")
    kern, cpu = kerns["cuda"], kerns["cpu"]
    if k6 != 1 or k5 != 0 or sum(launched.values()) != 1:
        raise AssertionError(f"{name}: K6 {k6} ({launched}), K5 {k5} launches")
    (shape, C, P), = launched
    plan = next(q for q in lex_plans(kern.W) if (q.shape, q.C, q.P) == (shape, C, P))
    if want_shape is not None and shape != want_shape:
        raise AssertionError(f"{name}: K6 ran {plan}, not the {want_shape} plan")
    status = outs["cuda"][0]
    resource = int((status == LEX_RESOURCE).sum())
    if resource > MAX_FALLBACK_SHARE * lanes:
        raise AssertionError(f"{name}: {resource} of {lanes} lanes would fall back")
    ms = cuda_ms(calls["cuda"])
    bound_ms, bound_by = lex_bound(p.m_total, p.n, p.objcnt, cpu.lane_nodes.numpy(),
                                   cpu.lane_iters.numpy(), cpu.lane_pivots.numpy())
    row = {
        "phase": "lex", "instance": name, "entry": "make_lex_kernel", "lanes": lanes,
        "seconds": times["cuda"], "cpu_seconds": times["cpu"], "ms": ms,
        "plain_ms": 1e3 * times["cpu"], "bound_ms": bound_ms, "bound_by": bound_by,
        "plan": f"{plan.shape} C={plan.C} P={plan.P}", "layout": plan.layout,
        "threads": plan.threads, "smem_bytes": plan.smem_bytes,
        "status_counts": np.bincount(status, minlength=4).tolist(),
        "ips": int(outs["cuda"][2].sum()), "fallback_lanes": resource,
        "nodes": cpu.nodes, "iters": cpu.iters, "pivots": int(cpu.lane_pivots.sum()),
        "path_nodes": cpu.path_nodes, "path_iters": cpu.path_iters,
        "us_per_path_iter": 1e3 * ms / max(1, cpu.path_iters),
        "cpu_bnb_steps": cpu.bnb_steps, "cpu_lp_steps": cpu.lp_steps,
        "equal_to_cpu": True, "card": smi,
    }
    err = max(float(np.abs(a.astype(np.float64) - b).max())
              for a, b in zip(outs["cuda"], outs["cpu"]))
    return row, err


def phase_lex():
    """The lex backend (``backend="jax"``: solver/lex_torch.py, its whole
    batch one launch of K6) on the card: three fronts against their
    goldens, IPs and the CPU's totals of the lanes' nodes and LP steps,
    with K6 launched once a batch and no other kernel, then one batch of
    the lex kernel at the fronts' shape (G3KP10) on their plan (``regs``)
    and on K5's ``packed``, one at the assignment cell's (3AP10) on its
    plan (``regs_block``) and on ``packed``, and one at 2AP20, each held against the same
    call on the CPU lane by lane, counts included, and K6 timed on each
    beside its plain version.  Returns the rows, K6's entry of the kernel
    table (without its launches) and K6's launches on the fronts."""
    import numpy as np
    import torch

    from moip_aira_tpu_torch.api import solve_front
    from moip_aira_tpu_torch.io import read_problem
    from moip_aira_tpu_torch.solver.cuda_lp import LAUNCHES, reset_launches
    from moip_aira_tpu_torch.solver.lex_torch import TorchLexBackend

    smi = card()
    rows = []
    k6_launches = 0
    for name, want_ips, want_nodes, want_iters in LEX_FRONTS:
        p = read_problem(os.path.join(EXAMPLES, f"{name}.lp"))
        be = TorchLexBackend(p, device="cuda")
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
        k6 = launches.pop("lex_bnb")
        if any(launches.values()) or not k6 == be.launches == be.device_batches > 0:
            raise AssertionError(
                f"{name}: the lex path launched K6 {k6} times over {be.device_batches} "
                f"batches, and {launches}"
            )
        if (be.nodes, be.iters) != (want_nodes, want_iters):
            raise AssertionError(
                f"{name}: {be.nodes} nodes and {be.iters} LP steps, the CPU "
                f"{want_nodes} and {want_iters}"
            )
        k6_launches += k6
        if be.fallback_count > MAX_FALLBACK_SHARE * be.lanes:
            raise AssertionError(
                f"{name}: {be.fallback_count} of {be.lanes} lanes fell back "
                f"(limit {MAX_FALLBACK_SHARE:.0%})"
            )
        st = front.backend_stats
        row = {
            "phase": "lex", "instance": name, "entry": "solve_front",
            "seconds": seconds, "points": int(front.points.shape[0]),
            "ips": int(front.ip_count), "rounds": front.rounds,
            "device_batches": be.device_batches, "lanes": be.lanes,
            "fallback_count": be.fallback_count, "nodes": be.nodes, "iters": be.iters,
            "path_nodes": be.path_nodes, "path_iters": be.path_iters,
            "host_syncs": be.host_syncs, "k6_launches": k6, "k6_plans": st["k6_plans"],
            "cpu_counts_equal": True,
            "us_per_node": seconds / max(1, be.nodes) * 1e6,
            "golden": True, "card": smi,
        }
        emit(row)
        rows.append(row)

    batches = {}
    for (name, lanes), want, force in ((LEX_PACKED_BATCH, "regs", None),
                                       (LEX_PACKED_BATCH, "packed", "packed"),
                                       (LEX_AP_BATCH, "regs_block", None),
                                       (LEX_AP_BATCH, "packed", "packed"),
                                       (LEX_BATCH, None, None)):
        row, err = lex_batch_row(name, lanes, want, smi, force)
        emit(row)
        rows.append(row)
        batches[name, want] = (row, err)
    row = batches[LEX_BATCH[0], None][0]
    fronts_plan = {want: batches[LEX_PACKED_BATCH[0], want][0] for want in ("regs", "packed")}
    ap_plan = {want: batches[LEX_AP_BATCH[0], want][0] for want in ("regs_block", "packed")}
    # no single PyTorch call computes a batch of lexicographic B&Bs
    entry = {
        "name": "lex_bnb",
        "route": "cuda",
        "source": "moip_aira_tpu_torch/csrc/lex_bnb.cu",
        # no Pallas kernel: the XLA while_loop of the reference's B&B
        "replaces": "moip_aira_tpu/solver/lex_jax.py:198",
        # over both batches, each held against the CPU lane by lane
        "max_abs_err": max(err for _, err in batches.values()),
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": None,
        "plan": row["plan"],
        # the same numbers at the fronts' shape: on the plan the fronts and
        # the mesh round launch (regs), and on K5's packed; and at the
        # assignment cell's, on its plan (regs_block) and on packed
        **{want: {key: r[key] for key in (
            "instance", "lanes", "ms", "plain_ms", "bound_ms", "bound_by", "plan")}
           for want, r in fronts_plan.items()},
        "3AP10": {want: {key: r[key] for key in (
            "lanes", "ms", "plain_ms", "bound_ms", "us_per_path_iter", "plan")}
                  for want, r in ap_plan.items()},
    }
    return rows, entry, k6_launches


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
    from moip_aira_tpu_torch.solver.wave import WaveLexBackend

    smi = card()
    p = read_problem(os.path.join(EXAMPLES, "G3AP05.lp"))
    # one domain on the first card, as make_mesh(8) gives it on a machine
    # with one card (phase mesh-devices spreads domains over devices)
    be = WaveLexBackend(p, device="cuda:0", mesh=make_mesh(8, devices=["cuda:0"]))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    front = solve_front(p, n_workers=6, backend=be, device="cuda:0", mesh_devices=8, dp="off")
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
    reset_launches()
    t0 = time.perf_counter()
    out = step(rhs, perm)
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    if not all(t.is_cuda for t in out):
        raise AssertionError("mesh: the distributed round's results left the card")
    # one K6 launch on each card of the mesh (its domains share a card)
    cards = len({str(d) for d in mesh.domain_devices()})
    round_launches = {k: v for k, v in LAUNCHES.items() if v}
    if round_launches != {"lex_bnb": cards}:
        raise AssertionError(f"mesh: the distributed round launched {round_launches}")
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
        "mesh_shape": mesh.shape, "lanes": B, "seconds": round_s, "k6_launches": cards,
        "results": results.tolist(), "lo": lo[0].tolist(), "hi": hi[0].tolist(),
        "card": smi,
    })


#: G3AP05, 6 workers, 8 domains: the JAX package's counts on 8 devices
#: (IPs, rounds, domain_ips, pre_ips)
MESH8_COUNTS = (118, 10, [19, 13, 7, 14, 13, 9], 43)


def sync_cards():
    """Wait for every visible card."""
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def mesh_front(name, devs, workers, fragments, want=None, **widths):
    """The front of ``name`` through solve_front with the wave over a mesh
    of ``devs`` (one domain each, the first one's device the wave's): the
    golden front, ``want`` (IPs, rounds, domain_ips, pre_ips) where given,
    one kernel serving every device wave and no other, lanes on every
    device of the mesh and kernel launches on every card in it."""
    import numpy as np

    from moip_aira_tpu_torch.api import solve_front
    from moip_aira_tpu_torch.io import read_problem
    from moip_aira_tpu_torch.parallel.mesh import make_mesh
    from moip_aira_tpu_torch.solver.cuda_lp import LAUNCHES, reset_launches
    from moip_aira_tpu_torch.solver.wave import WaveLexBackend
    from moip_aira_tpu_torch.utils.trace import GLOBAL_TIMINGS, recording

    p = read_problem(os.path.join(EXAMPLES, f"{name}.lp"))
    mesh = make_mesh(len(devs), devices=devs)
    be = WaveLexBackend(p, device=devs[0], mesh=mesh, fragments=fragments, **widths)
    label = f"{name} on {[str(d) for d in devs]}{' (fragments)' if fragments else ''}"
    spans0 = dict(GLOBAL_TIMINGS.totals)
    sync_cards()
    reset_launches()
    t0 = time.perf_counter()
    with recording():
        front = solve_front(
            p, n_workers=workers, backend=be, device=devs[0], mesh_devices=len(devs),
            dp="off",
        )
    sync_cards()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    spans = {
        k: v - spans0.get(k, 0.0)
        for k, v in GLOBAL_TIMINGS.totals.items()
        if v - spans0.get(k, 0.0) > 0.0
    }
    st = front.backend_stats
    if not np.array_equal(front.points, golden_front(name)):
        raise AssertionError(f"mesh-devices: {label}: the front differs from the golden")
    got = (front.ip_count, front.rounds, front.domain_ips, front.pre_ips)
    if want is not None and got != want:
        raise AssertionError(f"mesh-devices: {label}: (IPs, rounds, domain_ips, pre_ips) {got}")
    kernel = st["kernel"]
    if launches[kernel] != st["kernel_launches"] or any(
        v for k, v in launches.items() if k != kernel
    ):
        raise AssertionError(f"mesh-devices: {label}: launches {launches}, stats {st}")
    lanes, dev_launches = st["device_lanes"], st["device_launches"]
    cards = {str(d) for d in devs if d.type == "cuda"}
    # every device ran lanes, every card launched, and the first device,
    # which takes the first lanes of every wave, launched once a wave
    if (
        set(lanes) != {str(d) for d in devs}
        or not all(lanes.values())
        or not all(dev_launches[c] > 0 for c in cards)
        or (devs[0].type == "cuda" and dev_launches[str(devs[0])] != be.device_waves)
    ):
        raise AssertionError(f"mesh-devices: {label}: lanes {lanes}, launches {dev_launches}")
    fs = be.frag_stats
    if fragments:
        if fs.get("req_fallbacks", 0):
            raise AssertionError(f"mesh-devices: {label}: {fs['req_fallbacks']} requests fell back whole")
    else:
        check_fallbacks(label, be.verify_fallbacks, be.lp_count)
    row = {
        "phase": "mesh-devices",
        "instance": name,
        "devices": [str(d) for d in devs],
        "fragments": fragments,
        "engine": be.engine,
        "seconds": seconds,
        "ips": front.ip_count,
        "rounds": front.rounds,
        "domain_ips": front.domain_ips,
        "pre_ips": front.pre_ips,
        "waves": be.device_waves,
        "lps": be.lp_count,
        "verify_fallbacks": be.verify_fallbacks,
        "kernel": kernel,
        "launches": launches[kernel],
        "device_lanes": lanes,
        "device_launches": dev_launches,
        "records": fs["records"] if fragments else None,
        "host_recs": fs["host_recs"] if fragments else None,
        "mesh": st["mesh"],
        "host_spans_seconds": spans,
        "golden": True,
    }
    emit(row)
    return row


#: what a mesh run must share with the same mesh on one device
MESH_SAME = ("ips", "rounds", "domain_ips", "pre_ips", "waves", "lps",
             "verify_fallbacks", "records", "host_recs")


def phase_mesh_devices():
    """The wave over a mesh of several devices: the card and the host CPU
    on every machine, the visible cards where there are two or more (and
    the lex kernel's distributed round over them)."""
    import numpy as np
    import torch

    smi = card()
    cpu, card0 = torch.device("cpu"), torch.device("cuda", 0)
    rows = [
        mesh_front("G3AP05", [card0, cpu] * 4, 6, fragments, want=MESH8_COUNTS)
        for fragments in (False, True)
    ]
    # at real size, G3KP10 (791 waves, 18,379 LPs on two domains): each
    # wave waits for the plain K1 on the host's half of its lanes, which
    # took the 2AP20 front over the card and the CPU 207.5 s on an H100
    # host (292 waves of about 0.7 s), past the phase's budget
    rows.append(mesh_front("G3KP10", [card0, cpu], 2, False))
    cards = torch.cuda.device_count()
    if cards < 2:
        emit({
            "phase": "mesh-devices", "cross_card": False,
            "why": f"{cards} card visible: the 2AP40 (K2) and 2AP20 fragment "
                   f"(K3) fronts over a mesh of cards need two or more",
            "card": smi,
        })
        return rows
    # a power of two of the cards, so that every batch width splits evenly
    n = 1 << (cards.bit_length() - 1)
    devs = [torch.device("cuda", i) for i in range(n)]
    for name, fragments, widths in (
        ("2AP40", False, {"batch_width": 2048, "nodes_per_task": 32}),
        ("2AP20", True, {}),
    ):
        one = mesh_front(name, [card0] * n, n, fragments, **widths)
        many = mesh_front(name, devs, n, fragments, **widths)
        diff = {k: (one[k], many[k]) for k in MESH_SAME if one[k] != many[k]}
        if diff:
            raise AssertionError(f"mesh-devices: {name} on {n} cards differs from one card: {diff}")
        rows += [one, many]
        emit({
            "phase": "mesh-devices", "cross_card": True, "instance": name,
            "cards": n, "fragments": fragments, "same_counts_as_one_card": True,
            "seconds": [one["seconds"], many["seconds"]],
            "device_wait_seconds": [
                r["host_spans_seconds"].get("frag.device_exec" if fragments else "wave.device_lp")
                for r in (one, many)
            ],
            "card": smi,
        })
    # the lex kernel's distributed round over the cards (a lex kernel and
    # its K5 launches on each) against the same round on one card
    from moip_aira_tpu_torch.io import read_problem
    from moip_aira_tpu_torch.parallel.mesh import make_distributed_round, make_mesh

    p = read_problem(os.path.join(EXAMPLES, "G2AP05.lp"))
    k = p.objcnt
    outs = []
    for round_devs in ([card0] * n, devs):
        step, B = make_distributed_round(p, make_mesh(n, devices=round_devs))
        rhs = np.tile(p.initial_rhs(), (B, 1))
        perm = np.array([list(range(k))[:: 1 if i % 2 == 0 else -1] for i in range(B)])
        outs.append([t.cpu().numpy() for t in step(rhs, perm)])
    if not all(np.array_equal(a, b) for a, b in zip(*outs)) or (outs[1][0] != 0).any():
        raise AssertionError(f"mesh-devices: the distributed round over {n} cards: {outs}")
    emit({
        "phase": "mesh-devices", "cross_card": True, "instance": "G2AP05",
        "entry": "make_distributed_round", "cards": n, "lanes": B,
        "same_as_one_card": True, "results": outs[1][1].tolist(), "card": smi,
    })
    return rows


def phase_xla(seed, k1_rows=(), k2_rows=(), k1_fronts=None):
    """The wave's XLA engine on the card (K5, one launch a wave): its
    fronts against their goldens and the CPU's waves, LPs, re-solves and
    LP steps, beside K1's (``k1_fronts``: phase name -> rows), then its
    batches at K1's and K2's 256-lane shapes beside their kernels
    (``k1_rows``, ``k2_rows``), the first 2AP20 lanes bit for bit against
    the CPU's.  Returns the rows and K5's launches on the fronts."""
    import numpy as np
    import torch

    from moip_aira_tpu_torch.api import solve_front
    from moip_aira_tpu_torch.convert import lp_tensors
    from moip_aira_tpu_torch.io import read_problem
    from moip_aira_tpu_torch.solver.cuda_lp import LAUNCHES, reset_launches
    from moip_aira_tpu_torch.solver.verify import LPVerifier
    from moip_aira_tpu_torch.solver.wave import WaveLexBackend
    from moip_aira_tpu_torch.solver.xla_lp import XlaLPBatch

    dev = torch.device("cuda", 0)
    smi = card()
    k1_fronts = k1_fronts or {}
    rows = []
    torch.cuda.synchronize()
    reset_launches()
    for name, dtype, workers, k1_phase in XLA_FRONTS:
        p = read_problem(os.path.join(EXAMPLES, f"{name}.lp"))
        be = WaveLexBackend(
            p, device="cuda", engine="xla", dtype=dtype, fragments=False,
            batch_width=2048, nodes_per_task=32,
        )
        kern = be.lp_kernel
        if not (kern.kernel == "xla" and kern.W.is_cuda):
            raise AssertionError(f"{name}: the XLA engine is not on the card")
        k5_0 = LAUNCHES["simplex_dense"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        front = solve_front(p, n_workers=workers, backend=be, device="cuda", dp="off")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if not np.array_equal(front.points, golden_front(name)):
            raise AssertionError(f"{name} ({dtype}): the XLA front differs from the golden")
        st = front.backend_stats
        k5 = LAUNCHES["simplex_dense"] - k5_0
        if not (st["kernel"] == "xla" and st["kernel_launches"] == k5 == be.device_waves > 0):
            raise AssertionError(f"{name}: XLA engine stats {st}, K5 launches {k5}")
        got = (be.device_waves, be.lp_count, be.verify_fallbacks, st["lp_steps"])
        if got != XLA_CPU_COUNTS[name, dtype]:
            raise AssertionError(
                f"{name} ({dtype}): (waves, LPs, re-solves, LP steps) {got}, the CPU "
                f"{XLA_CPU_COUNTS[name, dtype]}"
            )
        limit = XLA_FALLBACK_SHARE.get(name, MAX_FALLBACK_SHARE)
        if be.verify_fallbacks > limit * be.lp_count:
            raise AssertionError(
                f"{name} ({dtype}): {be.verify_fallbacks} of {be.lp_count} LPs "
                f"re-solved on the host (limit {limit:.2%})"
            )
        k1 = next(
            (r for r in k1_fronts.get(k1_phase, ()) if r["instance"] == name), None
        )
        row = {
            "phase": "xla", "instance": name, "dtype": dtype, "workers": workers,
            "seconds": seconds, "ips": int(front.ip_count),
            "waves": be.device_waves, "lps": be.lp_count,
            "verify_fallbacks": be.verify_fallbacks,
            "steps": st["lp_steps"], "syncs": st["host_syncs"], "k5_launches": k5,
            "cpu_counts_equal": True,
            "mean_lanes": be.lp_count / max(1, be.device_waves),
            # the host inside the engine's calls, waiting on the card at
            # every step
            "lp_seconds": kern.seconds,
            "us_per_step": 1e6 * kern.seconds / max(1, st["lp_steps"]),
            "k1": None if k1 is None else {
                "phase": k1_phase, "seconds": k1["seconds"], "ips": k1["ips"],
                "waves": k1["waves"], "lps": k1["lps"],
                "verify_fallbacks": k1["verify_fallbacks"],
            },
            "golden": True, "card": smi,
        }
        emit(row)
        rows.append(row)
    k5_launches = LAUNCHES["simplex_dense"]
    if any(v for k, v in LAUNCHES.items() if k != "simplex_dense"):
        raise AssertionError(f"the XLA engine's fronts launched {dict(LAUNCHES)}")

    beside = {"dense_simplex": k1_rows, "revised_simplex": k2_rows}
    for name, offset, kernel in XLA_BATCHES:
        p = read_problem(os.path.join(EXAMPLES, f"{name}.lp"))
        t = lp_tensors(p, dev)
        # the lanes of the phase that timed the kernel (its first draw)
        _, (c, lo, hi) = scaled_lanes(
            p, t.row_scale, np.random.default_rng(seed + offset), name, LANES, dev
        )
        args = [torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (c, lo, hi)]
        xla = XlaLPBatch(t.W_np, dev, max_iters=2000)
        steps0 = xla.steps
        out = xla(*args)
        steps = xla.steps - steps0
        ms = cuda_ms(lambda: xla(*args))
        iters = out.iters.cpu().numpy()
        status = out.status.cpu().numpy()
        cert = LPVerifier(t.W_np).certify(
            c, lo, hi, status, out.basis.cpu().numpy(),
            out.at_upper.cpu().numpy().astype(bool),
        )
        k_row = next(
            (r for r in beside[kernel] if r["instance"] == name and r["start"] == "cold"
             and r["lanes"] == LANES), None,
        )
        row = {
            "phase": "xla", "instance": name, "entry": "XlaLPBatch", "lanes": LANES,
            "m": p.m_total, "nc": p.n + p.m_total, "ms": ms, "steps": steps,
            "us_per_step": 1e3 * ms / max(1, steps),
            "max_iters": int(iters.max()), "mean_iters": float(iters.mean()),
            "optimal": int((status == 0).sum()), "cert_ok": int(cert.ok.sum()),
            "k5_launches": xla.launches,
            "kernel": kernel, "kernel_ms": None if k_row is None else k_row["ms"],
            "kernel_max_iters": None if k_row is None else k_row["max_iters"],
            "card": smi,
        }
        if name == "2AP20":
            # the same call on the CPU: K5 pivots as the plain loop does
            k = XLA_CPU_LANES
            cpu = XlaLPBatch(t.W_np, "cpu", max_iters=2000)(*(a[:k].cpu() for a in args))
            head = type(out)(*(getattr(out, f)[:k].cpu() for f in out._fields))
            assert_bitwise(f"XLA engine {name}, first {k} lanes", head, cpu)
            row["cpu_lanes"] = k
            row["cpu_bitwise_equal_lanes"] = k
        emit(row)
        rows.append(row)
    if any(v for k, v in LAUNCHES.items() if k != "simplex_dense"):
        raise AssertionError(f"the XLA engine's batches launched {dict(LAUNCHES)}")
    return rows, k5_launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the kernel phase's LP lanes (default 0)")
    ap.add_argument("--only", choices=("mesh-devices", "xla", "dense-loop", "lex"),
                    help="run the probe, the build and this phase alone")
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
    if args.only == "mesh-devices":
        phase_mesh_devices()
        return 0
    if args.only == "xla":
        phase_xla(args.seed)
        return 0
    if args.only == "dense-loop":
        phase_dense_loop(args.seed)
        return 0
    if args.only == "lex":
        phase_lex()
        return 0
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
    k5_rows = phase_dense_loop(args.seed)
    _, k6_entry, lex_k6 = phase_lex()
    phase_mesh()
    phase_mesh_devices()
    _, xla_k5 = phase_xla(args.seed, k1_rows, k2_rows, {"cli": cli, "real": [real]})
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

    def k5_entry(rows, launches):
        # one launch on the lex backend's 2AP20 batch (its root LPs, f64),
        # in the plan K5 picks; no single PyTorch call computes a batched
        # simplex loop
        row = next(r for r in rows if r["kind"].startswith("lex batch") and r["chosen"])
        return {
            "name": "simplex_dense",
            "route": "cuda",
            "source": "moip_aira_tpu_torch/csrc/simplex_dense.cu",
            # no Pallas kernel: the XLA loop of the reference's solver
            "replaces": "moip_aira_tpu/solver/simplex_jax.py:283",
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,
            # the plans K5 picked at the dense-loop rows, and this row's
            "shapes": sorted({f"{r['shape']} C={r['C']} P={r['P']}" for r in rows if r["chosen"]}),
            "plan": f"{row['shape']} C={row['C']} P={row['P']}",
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
            # K5's main path: the XLA engine's fronts (the lex backend's
            # LPs run inside K6)
            k5_entry(k5_rows, xla_k5),
            # K6's: the lex backend's fronts, one launch a batch
            {**k6_entry, "launches": lex_k6},
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

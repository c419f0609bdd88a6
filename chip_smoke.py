#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (moip_aira_tpu_torch) on one GPU.

Drives the port's main path on the card — read_problem -> solve_front ->
bound sweep (k=2) or AIRA scheduler (k>=3) -> WaveLexBackend -> K1, the
hand-written CUDA simplex kernel -> f64 certification -> host branch and
bound — and fails unless every phase passes:

1. probe:   the card (nvidia-smi), torch, CUDA and nvcc versions;
2. build:   K1 from csrc/dense_simplex.cu, timed;
3. kernels: K1 against its plain PyTorch version on the card, at 2AP20's
            and G2AP05's LP shapes with 256 lanes (cold and half-warm):
            raw outputs equal bit for bit on every lane, then certified
            status and objective equal;
4. cli:     `python -m moip_aira_tpu_torch --backend wave --device cuda`
            on G2AP05, G3AP05, G3KP10 and KP2D50, each .out held against
            its golden, with at most 5% of the LPs re-solved on the host;
5. real:    the full 2AP20 front (n=400, m=42) through solve_front,
            held against its golden, with the same bound on re-solves.

Each phase prints one JSON line.  The last two lines are the kernel table
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

REPO = os.path.dirname(os.path.abspath(__file__))
EXAMPLES = os.path.join(REPO, "examples")
CLI_INSTANCES = ("G2AP05", "G3AP05", "G3KP10", "KP2D50")
KERNEL_SHAPES = ("2AP20", "G2AP05")
LANES = 256
OBJ_RTOL = 1e-3  # f32 objectives of two pivot paths (tests/test_simplex.py)
CERT_RTOL = 1e-7  # certified f64 optima of the same LP from two bases
# at most this share of a front's device LPs may fail f64 certification and
# be re-solved on the host (the H100 runs re-solve 0-0.16%)
MAX_FALLBACK_SHARE = 0.05


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


def phase_probe():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
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
    from moip_aira_tpu_torch.kernels.build import build, load

    t0 = time.perf_counter()
    lib = build("dense_simplex")
    load("dense_simplex")
    emit({
        "phase": "build",
        "kernel": "dense_simplex",
        "seconds": time.perf_counter() - t0,
        "library": os.path.relpath(lib, REPO),
    })


def _lanes(problem, rng, front):
    """LP lanes as the wave builds them: per lane one stage objective, an
    objective-bound box (free, or cut inside the golden front's range) and,
    on about half the lanes, a few branching fixes of integer variables."""
    import numpy as np

    from moip_aira_tpu_torch import INF, Sense

    p = problem
    n, k = p.n, p.objcnt
    m = p.m_total
    is_min = p.objsen is Sense.MIN
    c = np.zeros((LANES, n + m))
    lo = np.zeros((LANES, n + m))
    hi = np.zeros((LANES, n + m))
    ints = np.flatnonzero(p.is_int)
    for b in range(LANES):
        j = int(rng.integers(k))
        c[b, :n] = (1.0 if is_min else -1.0) * p.C[j]
        srhs = np.full(k, INF if is_min else -INF)
        root = b < LANES // 8
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


def phase_kernels(seed):
    """K1 against dense_lp_batch_ref on the same CUDA inputs."""
    import numpy as np
    import torch

    from moip_aira_tpu_torch.convert import lp_tensors
    from moip_aira_tpu_torch.io import read_problem
    from moip_aira_tpu_torch.solver.cuda_lp import make_cuda_lp_batch
    from moip_aira_tpu_torch.solver.simplex_torch import OPTIMAL, dense_lp_batch_ref
    from moip_aira_tpu_torch.solver.wave import WaveLexBackend

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed)
    rows = []
    for name in KERNEL_SHAPES:
        p = read_problem(os.path.join(EXAMPLES, f"{name}.lp"))
        # the backend certifies exactly as a wave does (_certify_wave); its
        # own K1 is not used here, so the main path's counts stay clean
        be = WaveLexBackend(p, device=dev, fragments=False)
        k1 = make_cuda_lp_batch(lp_tensors(p, dev).W_dev, dev)
        W = k1.W
        n, m = p.n, p.m_total
        c, lo, hi = _lanes(p, rng, golden_front(name))
        lo_s, hi_s = lo.copy(), hi.copy()
        lo_s[:, n:] *= be._row_scale
        hi_s[:, n:] *= be._row_scale

        def t32(a):
            return torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()

        ct, lot, hit = t32(c), t32(lo_s), t32(hi_s)
        wb_cold = torch.full((LANES, m), -1, dtype=torch.int32, device=dev)
        wa_cold = torch.zeros((LANES, n + m), dtype=torch.int32, device=dev)
        cold = k1(ct, lot, hit, wb_cold, wa_cold)
        # half the lanes warm from the bases the kernel's cold pass returned
        warm_rows = torch.arange(LANES, device=dev) % 2 == 0
        wb_warm = torch.where(warm_rows[:, None], cold.basis, -1).contiguous()
        wa_warm = torch.where(warm_rows[:, None], cold.at_upper, 0).contiguous()
        for label, wb, wa in (("cold", wb_cold, wa_cold), ("warm", wb_warm, wa_warm)):
            out_k = k1(ct, lot, hit, wb, wa)
            out_p = dense_lp_batch_ref(W, ct, lot, hit, wb, wa)
            torch.cuda.synchronize()
            # the raw outputs first: K1 and its plain version sum in one
            # fixed order, so every field of every lane must be equal —
            # before certification, whose host re-solves would hide a
            # kernel that gave up (ITER_LIMIT) or claimed wrongly
            for f in out_k._fields:
                a, b = getattr(out_k, f), getattr(out_p, f)
                if not torch.equal(a, b):
                    diff = (a != b).reshape(LANES, -1).any(dim=1)
                    bad = torch.nonzero(diff).flatten()[:10].tolist()
                    raise AssertionError(
                        f"{name} {label}: K1's raw {f} differs from the plain "
                        f"version's on lanes {bad}"
                    )
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
            row = {
                "phase": "kernels",
                "instance": name,
                "start": label,
                "m": m,
                "nc": n + m,
                "lanes": LANES,
                "optimal": int(opt.sum()),
                "infeasible": int((K["status"] == 1).sum()),
                "cert_ok_kernel": K["cert_ok"],
                "cert_ok_plain": P["cert_ok"],
                "host_resolved_kernel": K["resolved"],
                "host_resolved_plain": P["resolved"],
                "mean_iters_kernel": float(K["iters"].mean()),
                "mean_iters_plain": float(P["iters"].mean()),
                "bitwise_equal": True,
                "max_abs_err": float(err.max()) if err.size else 0.0,
                "ms": ms,
                "plain_ms": plain_ms,
            }
            emit(row)
            rows.append(row)
    return rows


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
            if not (launches > 0 and launches == stats["device_waves"]):
                raise AssertionError(
                    f"{name}: K1 launches {launches} != device waves "
                    f"{stats['device_waves']}"
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
                "golden": True,
            }
            emit(row)
            rows.append(row)
    return rows


def phase_real():
    """The full 2AP20 front at the bench's widths, in this process."""
    import numpy as np
    import torch

    from moip_aira_tpu_torch.api import solve_front
    from moip_aira_tpu_torch.io import read_problem
    from moip_aira_tpu_torch.trace import GLOBAL_TIMINGS
    from moip_aira_tpu_torch.solver.wave import WaveLexBackend

    p = read_problem(os.path.join(EXAMPLES, "2AP20.lp"))
    be = WaveLexBackend(
        p, device="cuda", fragments=False, batch_width=2048, nodes_per_task=32
    )
    spans0 = dict(GLOBAL_TIMINGS.totals)
    be.lp_kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    front = solve_front(p, backend=be, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    # host seconds by span: wave.device_lp is the host waiting on the card
    spans = {
        k: v - spans0.get(k, 0.0)
        for k, v in GLOBAL_TIMINGS.totals.items()
        if v - spans0.get(k, 0.0) > 0.0
    }
    launches = be.lp_kernel.launches
    if not np.array_equal(front.points, golden_front("2AP20")):
        raise AssertionError("2AP20: the front differs from the golden")
    if not (launches > 0 and launches == be.device_waves):
        raise AssertionError(
            f"2AP20: K1 launches {launches} != device waves {be.device_waves}"
        )
    check_fallbacks("2AP20", be.verify_fallbacks, be.lp_count)
    row = {
        "phase": "real",
        "instance": "2AP20",
        "seconds": seconds,
        "points": int(front.points.shape[0]),
        "ips": int(front.ip_count),
        "waves": be.device_waves,
        "lps": be.lp_count,
        "verify_fallbacks": be.verify_fallbacks,
        "launches": launches,
        "host_spans_seconds": spans,
        "golden": True,
    }
    emit(row)
    return row


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
    kernel_rows = phase_kernels(args.seed)
    phase_cli()
    real = phase_real()
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    big = next(
        r for r in kernel_rows if r["instance"] == "2AP20" and r["start"] == "cold"
    )
    emit({
        "kernels": [{
            "name": "dense_simplex",
            "route": "cuda",
            "source": "moip_aira_tpu_torch/csrc/dense_simplex.cu",
            "replaces": "moip_aira_tpu/solver/pallas_lp.py:116",
            "launches": real["launches"],
            "max_abs_err": max(r["max_abs_err"] for r in kernel_rows),
            "ms": big["ms"],
            "plain_ms": big["plain_ms"],
        }]
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

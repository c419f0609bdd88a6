"""K5, the dense simplex loop on the card, and its wrapper.

K5 (``csrc/simplex_dense.cu``) runs the whole loop of
``simplex_dense.DenseLPSolver`` -- start, steps and finish -- in one launch,
one block a lane, in float32 or float64, with every sum in the plain
version's order (``simplex_dense.xla_sum``, ``xla_dot``) and fused
multiply-adds exactly where the plain version fuses them, so its outputs
equal the plain version's on the CPU bit for bit.  It is no port of a
Pallas kernel: the JAX package runs this solver (``simplex_jax``) under XLA.
Its plain version is ``DenseLPSolver`` on CPU tensors, and
``DenseLPSolver.__call__`` on CUDA tensors launches it through
``launch_dense_loop``, once a call; nothing on a CUDA tensor runs the plain
step.

The launch plan (``dense_loop_plan``): one block a lane, a thread a column
in pricing and in the rank-1 update; the tableau in shared memory where it
fits beside the lane's vectors, else in a per-lane global scratch the
wrapper allocates.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from moip_aira_tpu_torch.kernels.build import load
from moip_aira_tpu_torch.solver.cuda_lp import LAUNCHES, STATIC_SMEM_RESERVE
from moip_aira_tpu_torch.solver.simplex_torch import LPOutcome

#: the kernel's name: its csrc/ source and its key in LAUNCHES
KERNEL = "simplex_dense"
# K5's limits, as csrc/simplex_dense.cu sets them: threads a block (at
# least four warps: three run the serial row sums side by side), and the
# longest sum its windowed order takes
K5_MIN_THREADS = 128
K5_MAX_THREADS = 512
K5_MAX_COLUMNS = 32**3
#: the value types K5 is built for, by their size in bytes
DTYPE_SIZES = {torch.float32: 4, torch.float64: 8}


def _seg(nbytes: int) -> int:
    return (nbytes + 15) & ~15


def dense_loop_smem_bytes(m: int, nc: int, dsize: int, t_smem: bool) -> int:
    """A K5 block's dynamic shared bytes (``k5_layout`` of
    csrc/simplex_dense.cu), each array 16-byte aligned: the tableau (m x nc)
    when it sits there; c, lo, hi, the nonbasic values at each bound, the
    bound flips' lengths and a column buffer (nc values each); nine row
    vectors (m values each); the window sums of a column sum (ceil(nc /
    32) values); the basis (m int32); three column flags and two row flags
    (a byte each)."""
    total = _seg(m * nc * dsize) if t_smem else 0
    total += 7 * _seg(nc * dsize) + 9 * _seg(m * dsize) + _seg(-(-nc // 32) * dsize)
    return total + _seg(4 * m) + 3 * _seg(nc) + 2 * _seg(m)


@dataclass(frozen=True)
class DenseLoopPlan:
    """One K5 launch: a block of ``threads`` a lane, the tableau in shared
    memory (``t_smem``) or in a global scratch of lanes x m x nc values."""

    m: int
    nc: int
    dsize: int
    threads: int
    t_smem: bool

    @property
    def smem_bytes(self) -> int:
        return dense_loop_smem_bytes(self.m, self.nc, self.dsize, self.t_smem)

    @property
    def layout(self) -> str:
        return "T in shared memory" if self.t_smem else "T in global scratch"


def dense_loop_plan(m: int, nc: int, dtype: torch.dtype, smem_cap: int) -> DenseLoopPlan:
    """K5's launch for LPs of m rows and nc columns in ``dtype`` on a card
    whose blocks may opt into ``smem_cap`` shared bytes: a thread a column
    (a multiple of 32, from K5_MIN_THREADS to K5_MAX_THREADS), the tableau
    in shared memory when it fits beside the vectors (2AP20's 42 x 442 in
    float64: 148.5 KB of it), else in global memory (2AP40's 82 x 1,682).
    Raises ValueError for a dtype K5 has no build for, or when not even the
    vectors fit."""
    if dtype not in DTYPE_SIZES:
        raise ValueError(f"K5 runs float32 or float64, not {dtype}")
    if not (m >= 1 and m <= nc <= K5_MAX_COLUMNS):
        raise ValueError(f"K5 takes no LP of {m} rows and {nc} columns")
    dsize = DTYPE_SIZES[dtype]
    threads = min(K5_MAX_THREADS, max(K5_MIN_THREADS, 32 * -(-nc // 32)))
    cap = smem_cap - STATIC_SMEM_RESERVE
    for t_smem in (True, False):
        if dense_loop_smem_bytes(m, nc, dsize, t_smem) <= cap:
            return DenseLoopPlan(m, nc, dsize, threads, t_smem)
    raise ValueError(
        f"K5's vectors for {m} rows and {nc} columns need "
        f"{dense_loop_smem_bytes(m, nc, dsize, False)} shared bytes, the card gives {cap}"
    )


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load(KERNEL)
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    pi = ctypes.POINTER(ci)
    lib.simplex_dense_smem_optin.argtypes = [pi]
    lib.simplex_dense_smem_optin.restype = ci
    lib.simplex_dense_smem_bytes.argtypes = [ci] * 4
    lib.simplex_dense_smem_bytes.restype = ctypes.c_longlong
    lib.simplex_dense_launch.argtypes = [
        ci, vp, ci, ci, ci,  # dsize, W, m, n, batch
        vp, vp, vp, vp,  # c, lo, hi, active
        ci, cd, cd, cd, cd, ci,  # max_iters, the four tolerances, stall_limit
        ci, ci, vp,  # the plan: threads, tableau in shared memory, scratch
        vp, vp, vp, vp, vp, vp,  # status, obj, x, basis, at_upper, iters
        vp,  # stream
    ]
    lib.simplex_dense_launch.restype = ci
    return lib


@functools.lru_cache(maxsize=None)
def device_smem_cap(device: int) -> int:
    """The shared bytes a block may opt into on card ``device``."""
    smem = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = _lib().simplex_dense_smem_optin(ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"K5: reading the card's limits failed: CUDA error {err}")
    return smem.value


def check_lanes(W: torch.Tensor, c, lo, hi, active) -> None:
    """Raise unless c, lo and hi are contiguous (B, nc) tensors of W's dtype
    on W's device and ``active`` is None or a (B,) bool tensor there."""
    nc = W.shape[1]
    B = c.shape[0] if c.dim() else -1
    for name, t in (("c", c), ("lo", lo), ("hi", hi)):
        if t.device != W.device:
            raise ValueError(f"{name} lies on {t.device}, the solver on {W.device}")
        if t.dtype != W.dtype:
            raise TypeError(f"{name} must be {W.dtype}, got {t.dtype}")
        if tuple(t.shape) != (B, nc):
            raise ValueError(f"{name} must have shape {(B, nc)}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if active is not None:
        if active.device != W.device:
            raise ValueError(f"active lies on {active.device}, the solver on {W.device}")
        if active.dtype != torch.bool or tuple(active.shape) != (B,):
            raise ValueError(f"active must be a bool tensor of shape {(B,)}")
        if not active.is_contiguous():
            raise ValueError("active must be contiguous")


def launch_dense_loop(
    W: torch.Tensor, c, lo, hi, active, max_iters: int, feas_tol: float,
    cost_tol: float, pivot_tol: float, progress_tol: float, stall_limit: int,
) -> LPOutcome:
    """K5 on the lanes (c, lo, hi, active) over the system W = [A | -I]:
    the outputs of ``DenseLPSolver`` (status, obj, x, basis, at_upper,
    iters), on W's card.  One launch on the current stream; raises for CPU
    tensors, for inputs ``check_lanes`` refuses and for a failed launch."""
    if W.device.type != "cuda":
        raise ValueError(f"K5 runs on a CUDA device, not {W.device}")
    check_lanes(W, c, lo, hi, active)
    if not W.is_contiguous():
        raise ValueError("W must be contiguous")
    m, nc = W.shape
    n = nc - m
    B = c.shape[0]
    dev, dt = W.device, W.dtype
    out = LPOutcome(
        torch.empty(B, dtype=torch.int32, device=dev),
        torch.empty(B, dtype=dt, device=dev),
        torch.empty(B, n, dtype=dt, device=dev),
        torch.empty(B, m, dtype=torch.int64, device=dev),
        torch.empty(B, nc, dtype=torch.bool, device=dev),
        torch.empty(B, dtype=torch.int32, device=dev),
    )
    if B == 0:
        return out
    plan = dense_loop_plan(m, nc, dt, device_smem_cap(dev.index or 0))
    lib = _lib()
    kb = lib.simplex_dense_smem_bytes(m, n, plan.dsize, int(plan.t_smem))
    if kb != plan.smem_bytes:
        raise RuntimeError(f"K5 counts {kb} shared bytes for {plan}, the plan {plan.smem_bytes}")
    scratch = None if plan.t_smem else torch.empty(B, m, nc, dtype=dt, device=dev)
    status, obj, x, basis, at_upper, iters = out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.simplex_dense_launch(
            plan.dsize, W.data_ptr(), m, n, B,
            c.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            None if active is None else active.data_ptr(),
            int(max_iters), float(feas_tol), float(cost_tol), float(pivot_tol),
            float(progress_tol), int(stall_limit),
            plan.threads, int(plan.t_smem),
            None if scratch is None else scratch.data_ptr(),
            status.data_ptr(), obj.data_ptr(), x.data_ptr(),
            basis.data_ptr(), at_upper.data_ptr(), iters.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"K5 launch of {plan} failed: CUDA error {err}")
    LAUNCHES[KERNEL] += 1
    return out

"""K5, the dense simplex loop on the card, its launch plan and its wrapper.

K5 (``csrc/simplex_dense.cu``) runs the whole loop of
``simplex_dense.DenseLPSolver`` -- start, steps and finish -- in one launch,
in float32 or float64, with every sum in the plain version's order
(``simplex_dense.xla_sum``, ``xla_dot``) and fused multiply-adds exactly
where the plain version fuses them, so its outputs equal the plain
version's on the CPU bit for bit.  It is no port of a Pallas kernel: the
JAX package runs this solver (``simplex_jax``) under XLA.  Its plain version
is ``DenseLPSolver`` on CPU tensors, and ``DenseLPSolver.__call__`` on CUDA
tensors launches it through ``launch_dense_loop``, once a call; nothing on
a CUDA tensor runs the plain step.

The launch plan (``dense_loop_plan``) runs each lane in one of three
shapes, as K1's (``cuda_lp.dense_launch_plan``): ``packed`` (a warp a lane,
P lanes a block, for LPs of at most 32 rows and 128 columns), ``block`` (a
block a lane, the whole tableau in its shared memory) and ``cluster`` (a
lane on C blocks, each holding the columns of whole windows of the padded
nc-long sums, ``slice_of``).  An LP whose tableau slice fits no block of a
cluster of 8 (2AP50 and larger in float64, 2AP60 and larger in float32)
takes the last resort, ``global``: the cluster shape with each block's
slice in a global scratch and everything else in shared memory.  The plan,
the card's limits, the clusters it holds and the kernel's own count of its
shared bytes are worked out once per (shape, dtype, card, lanes) and
kept.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from contextlib import nullcontext
from dataclasses import dataclass
from typing import ClassVar

import torch

from moip_aira_tpu_torch.kernels.build import load
from moip_aira_tpu_torch.solver.cuda_lp import LAUNCHES, STATIC_SMEM_RESERVE, pick_cluster
from moip_aira_tpu_torch.solver.simplex_torch import LPOutcome

#: the kernel's name: its csrc/ source and its key in LAUNCHES
KERNEL = "simplex_dense"
# K5's limits, as csrc/simplex_dense.cu sets them: threads a block of any
# shape, the packed shape's rows, columns and lanes a block, the rows a row
# sum of two levels takes and the longest column sum
K5_MAX_THREADS = 256
K5_PACK_ROWS = 32
K5_PACK_COLS = 128
K5_MAX_PACK = 8
K5_MAX_ROWS = 32**2
K5_MAX_COLUMNS = 32**3
#: lanes (warps) a block of the packed shape
K5_PACK_LANES = 4
#: the fewest windows of 32 columns a block of a split lane keeps (K1's
#: DENSE_MIN_SLICE of 64 columns)
K5_MIN_SLICE_WINDOWS = 2
#: K5's execution shapes, by their code in csrc/simplex_dense.cu
SHAPES = ("packed", "block", "cluster", "global")
#: the shapes that split a lane over a cluster of C blocks
SPLIT = ("cluster", "global")
#: the value types K5 is built for, by their size in bytes
DTYPE_SIZES = {torch.float32: 4, torch.float64: 8}
#: XLA's CPU backend sums at most this many terms in one pass, in float32
#: and float64 alike; a longer axis is cut into windows of this many terms,
#: zero-padded at both ends (``windows``, ``pad_low``): the order of every
#: sum of K5 and of its plain version (``simplex_dense.xla_sum``)
XLA_WINDOW = 32
# a published winner's values and integers, and the step's integers
_MAIL_T, _MAIL_I, _HEAD_I = 7, 3, 8


def windows(L: int) -> int:
    """The windows of XLA_WINDOW terms an L-long sum is cut into."""
    return -(-L // XLA_WINDOW)


def pad_low(L: int) -> int:
    """The zeros padded below an L-long sum's first term (half the
    padding, rounded down; the rest goes high)."""
    return (windows(L) * XLA_WINDOW - L) // 2


def items(L: int) -> int:
    """The first level of ``xla_sum`` over L terms: the whole chain when
    L <= 32, else a window each."""
    return 1 if L <= XLA_WINDOW else windows(L)


@dataclass(frozen=True)
class Slice:
    """Block r's part of a lane split over C blocks: the windows [w0, w1)
    of the padded nc-long sums and their columns [j0, j1); ``pitch`` is the
    tableau's row length in every block."""

    pitch: int
    w0: int
    w1: int
    j0: int
    j1: int


def slice_of(nc: int, C: int, r: int) -> Slice:
    """Block r of C: ceil(items(nc) / C) windows a block, so that every
    window of an nc-long sum (padded ``pad_low(nc)`` zeros low) lies in one
    block and starts at column 32 w - pad_low(nc) (``slice_of`` of
    csrc/simplex_dense.cu)."""
    nw = items(nc)
    wpb = -(-nw // C)
    w0 = min(nw, r * wpb)
    w1 = min(nw, w0 + wpb)
    if nc <= XLA_WINDOW:
        j0, j1 = (0 if r == 0 else nc), nc
    else:
        lo = pad_low(nc)
        j0 = max(0, min(nc, w0 * XLA_WINDOW - lo))
        j1 = max(0, min(nc, w1 * XLA_WINDOW - lo))
    pitch = nc if C == 1 or nc <= XLA_WINDOW else wpb * XLA_WINDOW
    return Slice(pitch, w0, w1, j0, j1)


def _seg(nbytes: int) -> int:
    return (nbytes + 15) & ~15


def dense_loop_smem_bytes(shape: str, m: int, nc: int, C: int, P: int, dsize: int) -> int:
    """A K5 block's dynamic shared bytes (``k5_layout`` of
    csrc/simplex_dense.cu), each array 16-byte aligned, for one lane (P
    lanes in the packed shape): its tableau slice (m x pitch); c, lo, hi,
    the nonbasic values at each bound, the bound flips' lengths, z and the
    nonbasic objective's terms (a pitch each) and three column flags (a
    byte each); ten row vectors, the basis (int32) and two row flags; the
    row sums' items (3 items(m)) and the nonbasic objective's (2
    items(nc)); on a cluster the published
    columns (2 C m) and winners (2 C of 7 values and 3 int32); the warps'
    winners (block and cluster shapes: eight warps of 2 values and 2
    int32); the step's 8 int32 and 2 values.  The global shape keeps no
    tableau here."""
    pitch = slice_of(nc, C, 0).pitch
    col, row = pitch * dsize, m * dsize
    warps = 0 if shape == "packed" else K5_MAX_THREADS // 32
    mail = 2 * C if shape in SPLIT else 0
    parts = (
        [0 if shape == "global" else m * col] + [col] * 8 + [pitch] * 3 + [row] * 10 + [4 * m, m, m]
        + [3 * items(m) * dsize, 2 * items(nc) * dsize,
           2 * C * m * dsize if shape in SPLIT else 0,
           2 * warps * dsize, 2 * warps * 4, mail * _MAIL_T * dsize, mail * _MAIL_I * 4,
           _HEAD_I * 4, 2 * dsize]
    )
    lane = sum(_seg(p) for p in parts)
    return P * lane if shape == "packed" else lane


@dataclass(frozen=True)
class DenseLoopPlan:
    """One K5 launch: the execution shape ("packed": P lanes a block, one
    warp each; "block": one block of ``threads`` a lane; "cluster": C such
    blocks a lane, block r owning the columns of ``slice_of(nc, C, r)``;
    "global": "cluster" with the tableau slices in a global scratch), for
    LPs of m rows and nc columns of ``dsize``-byte values."""

    #: the kernel the plan launches, in messages
    KERNEL: ClassVar[str] = "K5"

    m: int
    nc: int
    dsize: int
    shape: str
    C: int
    threads: int
    P: int = 1

    @property
    def code(self) -> int:
        return SHAPES.index(self.shape)

    @property
    def slices(self) -> tuple:
        """Each block's ``Slice``."""
        return tuple(slice_of(self.nc, self.C, r) for r in range(self.C))

    @property
    def smem_bytes(self) -> int:
        return dense_loop_smem_bytes(self.shape, self.m, self.nc, self.C, self.P, self.dsize)

    @property
    def layout(self) -> str:
        """Where the tableau lies: "P x T" (P lanes' tableaux in a block's
        shared memory), "T" (the lane's), "T/C" (its slice in each block of
        a cluster of C), "T/C global" (each slice in global memory)."""
        if self.shape == "packed":
            return f"{self.P} x T"
        if self.shape == "global":
            return f"T/{self.C} global"
        return "T" if self.C == 1 else f"T/{self.C}"

    @property
    def scratch_values(self) -> int:
        """The global scratch's values a lane: its C slices of m x pitch
        (0 but for the global shape)."""
        return self.C * self.m * self.slices[0].pitch if self.shape == "global" else 0

    @classmethod
    def pick(cls, m: int, nc: int, dtype, lanes: int, smem_cap: int, sms: int,
             held) -> "DenseLoopPlan":
        """The kernel's rule for ``lanes`` lanes (``dense_loop_plan``),
        which ``plan_on`` applies on a card."""
        return dense_loop_plan(m, nc, dtype, lanes, smem_cap, sms, held, cls)

    def kernel_smem_bytes(self, defines: tuple = ()) -> int:
        """The kernel's own count of the plan's shared bytes."""
        return _lib(defines).simplex_dense_smem_bytes(
            self.dsize, self.code, self.m, self.nc - self.m, self.C, self.P
        )

    def kernel_clusters(self) -> int:
        """How many clusters of the plan (blocks, for C = 1) the current
        card holds at once, or minus the CUDA error."""
        return _lib().simplex_dense_max_clusters(
            self.dsize, self.code, self.m, self.nc - self.m, self.C, self.threads, self.P
        )


def packs(m: int, nc: int) -> bool:
    """Whether a warp can run the lane: a row for each of its 32 threads and
    at most four columns each."""
    return m <= K5_PACK_ROWS and nc <= K5_PACK_COLS


def cluster_sizes(nc: int) -> list:
    """The clusters a K5 lane of ``nc`` columns may take: 2, 4 and 8
    blocks, each keeping at least K5_MIN_SLICE_WINDOWS windows, the last
    one a column at least."""
    out = []
    for C in (2, 4, 8):
        if nc > XLA_WINDOW and -(-items(nc) // C) >= K5_MIN_SLICE_WINDOWS:
            last = slice_of(nc, C, C - 1)
            if last.j1 > last.j0:
                out.append(C)
    return out


def _dsize(dtype) -> int:
    if dtype not in DTYPE_SIZES:
        raise ValueError(f"K5 runs float32 or float64, not {dtype}")
    return DTYPE_SIZES[dtype]


def loop_plan_for(m: int, nc: int, dtype, shape: str, C: int, smem_cap: int,
                  P: int = K5_PACK_LANES, cls=DenseLoopPlan) -> DenseLoopPlan:
    """K5's launch of the given shape (C blocks a lane for "cluster" and
    "global", P lanes a block for "packed") on a card whose blocks may opt into
    ``smem_cap`` shared bytes, or K6's (``cls``: the plan's class, which
    counts its kernel's shared bytes).  A block of the block or cluster shape
    takes a thread for each of its columns and each of its windows of the
    objective's column sums (an item each), ceil(items / K5_MAX_THREADS)
    items a thread, as few threads as spread them evenly.  Raises
    ValueError for a dtype K5 has no build for, an LP the shape cannot
    take, or shared memory that does not fit."""
    dsize = _dsize(dtype)
    name = cls.KERNEL
    if not (1 <= m <= K5_MAX_ROWS and m <= nc <= K5_MAX_COLUMNS):
        raise ValueError(f"{name} takes no LP of {m} rows and {nc} columns")
    cap = smem_cap - STATIC_SMEM_RESERVE
    if shape == "packed":
        if not packs(m, nc) or not 1 <= P <= K5_MAX_PACK or C != 1:
            raise ValueError(f"{name} packs no LP of {m} rows and {nc} columns, {P} a block")
        plan = cls(m, nc, dsize, shape, 1, 32 * P, P)
    elif shape in ("block",) + SPLIT:
        if (shape == "block") != (C == 1) or C > 1 and C not in cluster_sizes(nc):
            raise ValueError(f"{name}'s {shape} shape takes no cluster of {C} at {nc} columns")
        work = max((s.j1 - s.j0) + (s.w1 - s.w0) for s in (slice_of(nc, C, r) for r in range(C)))
        per = -(-work // K5_MAX_THREADS)
        plan = cls(m, nc, dsize, shape, C, max(32, 32 * -(-work // (32 * per))))
    else:
        raise ValueError(f"{name} has no shape {shape!r}")
    if plan.smem_bytes > cap:
        raise ValueError(
            f"{name}'s {plan.layout} for {m} rows and {nc} columns needs "
            f"{plan.smem_bytes} shared bytes, the card gives {cap}"
        )
    return plan


def split_plans(m: int, nc: int, dtype, smem_cap: int, cls=DenseLoopPlan) -> dict:
    """The plans ``dense_loop_plan`` chooses among for an LP no warp runs,
    by C (1: a block): the block plan and each cluster plan whose shared
    memory holds the tableau, or, when none does, each global plan that
    fits."""
    out = {}
    for shape, C in [("block", 1)] + [("cluster", C) for C in cluster_sizes(nc)]:
        try:
            out[C] = loop_plan_for(m, nc, dtype, shape, C, smem_cap, cls=cls)
        except ValueError:
            continue
    if not out:
        for C in cluster_sizes(nc):
            try:
                out[C] = loop_plan_for(m, nc, dtype, "global", C, smem_cap, cls=cls)
            except ValueError:
                continue
    return out


def dense_loop_plan(m: int, nc: int, dtype, lanes: int, smem_cap: int, sms: int,
                    held, cls=DenseLoopPlan) -> DenseLoopPlan:
    """K5's launch for ``lanes`` LPs of m rows and nc columns in ``dtype``
    on a card of ``sms`` SMs whose blocks may opt into ``smem_cap`` shared
    bytes and which holds ``held[C]`` clusters of C blocks of the plan
    ``split_plans`` gives that C at once (1: blocks of the block plan).
    K1's rule (``cuda_lp.dense_launch_plan``):

    * ``packed`` (four lanes a block) whenever a warp can run the lane
      (``packs``: G3KP10, KP2D50, G2AP05, G3AP05);
    * else, when one block holds the tableau, ``cluster`` at the largest C
      of ``cluster_sizes`` whose slice fits and of which the card holds a
      cluster for every lane at once, else ``block`` (2AP20);
    * else (2AP40's 552 KB float32 tableau, 1.1 MB in float64)
      ``cluster`` at the largest C whose slice fits and at which the card
      holds every lane (``pick_cluster``); when it holds them at none, the
      C of the fewest rounds of clusters, the larger C among equals;
    * else (no block of a cluster of 8 holds its slice: 2AP50 and larger
      in float64, 2AP60 and larger in float32) ``global`` by the same rule.

    K6 (``cls``) takes the same rule over the plans that fit its own
    shared bytes.  Raises ValueError when no shape fits."""
    _dsize(dtype)
    if not (1 <= m <= K5_MAX_ROWS and m <= nc <= K5_MAX_COLUMNS):
        raise ValueError(f"{cls.KERNEL} takes no LP of {m} rows and {nc} columns")
    lanes = max(lanes, 1)
    if packs(m, nc):
        try:
            return loop_plan_for(m, nc, dtype, "packed", 1, smem_cap, cls=cls)
        except ValueError:
            pass
    plans = split_plans(m, nc, dtype, smem_cap, cls)
    if not plans:  # the smallest global plan's refusal, else the block's
        sizes = cluster_sizes(nc)
        loop_plan_for(m, nc, dtype, "global" if sizes else "block", max(sizes, default=1),
                      smem_cap, cls=cls)
    fits = sorted(C for C in plans if C > 1)
    if 1 in plans:
        return plans[max([1] + [C for C in fits if lanes <= held.get(C, 0)])]
    if any(lanes <= min(held.get(C, 0), sms // C) for C in fits):
        return plans[pick_cluster(fits, [], lanes, sms, held)]
    return plans[min(fits, key=lambda C: (-(-lanes // max(1, held.get(C, 0))), -C))]


def plans_that_fit(m: int, nc: int, dtype, smem_cap: int, cls=DenseLoopPlan) -> list:
    """Every plan K5 (K6: ``cls``) can launch for the shape: a warp a lane
    at P = 1, 2, 4 and 8; a block; each cluster size that fits, with the
    tableau in shared and in global memory."""
    out = []
    for shape, C, P in (
        [("packed", 1, P) for P in (1, 2, 4, 8)]
        + [("block", 1, 1)] + [(shape, C, 1) for shape in SPLIT for C in (2, 4, 8)]
    ):
        try:
            out.append(loop_plan_for(m, nc, dtype, shape, C, smem_cap, P, cls))
        except ValueError:
            continue
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    pi = ctypes.POINTER(ci)
    lib.simplex_dense_device_limits.argtypes = [pi, pi]
    lib.simplex_dense_device_limits.restype = ci
    lib.simplex_dense_smem_bytes.argtypes = [ci] * 6
    lib.simplex_dense_smem_bytes.restype = ctypes.c_longlong
    lib.simplex_dense_max_clusters.argtypes = [ci] * 7
    lib.simplex_dense_max_clusters.restype = ci
    lib.simplex_dense_launch.argtypes = [
        ci, vp, ci, ci, ci,  # dsize, W, m, n, batch
        vp, vp, vp, vp,  # c, lo, hi, active
        ci, cd, cd, cd, cd, ci,  # max_iters, the four tolerances, stall_limit
        ci, ci, ci, ci, vp,  # the plan: shape, C, threads, P; the global scratch
        vp, vp, vp, vp, vp, vp,  # status, obj, x, basis, at_upper, iters
        vp,  # stream
    ]
    lib.simplex_dense_launch.restype = ci
    return lib


@functools.lru_cache(maxsize=None)
def _lib(defines: tuple = ()) -> ctypes.CDLL:
    """K5's library (with extra ``-D`` flags: an instrumented variant of
    tools/k5_bench.py beside the production one)."""
    return _bind(load(KERNEL, defines))


@functools.lru_cache(maxsize=None)
def device_limits(device: int) -> tuple:
    """(shared bytes a block may opt into, SMs) of card ``device``: the
    card's, whichever kernel the plan is for."""
    smem, sms = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        err = _lib().simplex_dense_device_limits(ctypes.byref(smem), ctypes.byref(sms))
    if err != 0:
        raise RuntimeError(f"reading the card's limits failed: CUDA error {err}")
    return smem.value, sms.value


@functools.lru_cache(maxsize=None)
def max_clusters(device: int, plan: DenseLoopPlan) -> int:
    """How many clusters of ``plan`` (blocks, for C = 1) card ``device``
    holds at once (cudaOccupancyMaxActiveClusters of the plan's kernel)."""
    with torch.cuda.device(device):
        got = plan.kernel_clusters()
    if got < 0:
        raise RuntimeError(f"{plan.KERNEL}: occupancy of {plan} failed: CUDA error {-got}")
    return got


@functools.lru_cache(maxsize=None)
def held(device: int, m: int, nc: int, dtype, cls=DenseLoopPlan) -> dict:
    """Clusters of each size C card ``device`` holds at once under the
    plan ``split_plans`` gives that C (1: blocks of the block plan), for
    K5 or K6 (``cls``)."""
    smem, _ = device_limits(device)
    return {C: max_clusters(device, plan)
            for C, plan in split_plans(m, nc, dtype, smem, cls).items()}


@functools.lru_cache(maxsize=4096)
def plan_on(device: int, m: int, nc: int, dtype, lanes: int, cls=DenseLoopPlan) -> DenseLoopPlan:
    """The rule of K5 or K6 (``cls.pick``) on card ``device``,
    worked out once per shape, dtype, card and lane count."""
    smem, sms = device_limits(device)
    h = {} if packs(m, nc) else held(device, m, nc, dtype, cls)
    return cls.pick(m, nc, dtype, lanes, smem, sms, h)


def device_index(dev: torch.device) -> int:
    """The ordinal of CUDA device ``dev`` (the current one when it names
    none)."""
    return dev.index if dev.index is not None else torch.cuda.current_device()


def loop_plan(W: torch.Tensor, lanes: int) -> DenseLoopPlan:
    """The launch ``dense_loop_plan`` picks for ``lanes`` lanes over the
    system W on W's card (worked out once per shape, dtype, card and lane
    count)."""
    m, nc = W.shape
    return plan_on(device_index(W.device), m, nc, W.dtype, int(lanes))


def loop_plans(W: torch.Tensor) -> list:
    """Every plan K5 can launch for the system W on W's card."""
    m, nc = W.shape
    return plans_that_fit(m, nc, W.dtype, device_limits(device_index(W.device))[0])


@functools.lru_cache(maxsize=None)
def check_bytes(plan: DenseLoopPlan, defines: tuple = ()) -> None:
    """The kernel's own count of the plan's shared bytes against the
    plan's, once per plan and build."""
    kb = plan.kernel_smem_bytes(defines)
    if kb != plan.smem_bytes:
        raise RuntimeError(
            f"{plan.KERNEL} counts {kb} shared bytes for {plan}, the plan {plan.smem_bytes}"
        )


def check_tensor(name: str, t: torch.Tensor, dev, dtype, shape) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``shape`` and ``dtype``
    on ``dev``."""
    if t.device != dev:
        raise ValueError(f"{name} lies on {t.device}, the kernel on {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_lanes(W: torch.Tensor, c, lo, hi, active) -> None:
    """Raise unless c, lo and hi are contiguous (B, nc) tensors of W's dtype
    on W's device and ``active`` is None or a (B,) bool tensor there."""
    nc = W.shape[1]
    B = c.shape[0] if c.dim() else -1
    for name, t in (("c", c), ("lo", lo), ("hi", hi)):
        check_tensor(name, t, W.device, W.dtype, (B, nc))
    if active is not None:
        if active.dtype != torch.bool:
            raise ValueError(f"active must be a bool tensor of shape {(B,)}")
        check_tensor("active", active, W.device, torch.bool, (B,))


def launch_dense_loop(
    W: torch.Tensor, c, lo, hi, active, max_iters: int, feas_tol: float,
    cost_tol: float, pivot_tol: float, progress_tol: float, stall_limit: int,
    plan: DenseLoopPlan | None = None, defines: tuple = (),
    plan_launches: Counter | None = None,
) -> LPOutcome:
    """K5 on the lanes (c, lo, hi, active) over the system W = [A | -I]:
    the outputs of ``DenseLPSolver`` (status, obj, x, basis, at_upper,
    iters), on W's card.  One launch on the current stream, of ``plan``
    (default: ``loop_plan(W, lanes)``), counted in ``plan_launches`` by
    the plan's (shape, C, P) when given; raises for CPU tensors, for inputs
    ``check_lanes`` refuses, for a plan of another shape and for a failed
    launch (a plan that does not fit is refused before it)."""
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
    if plan is None:
        plan = loop_plan(W, B)
    if (plan.m, plan.nc, plan.dsize) != (m, nc, _dsize(dt)):
        raise ValueError(f"{plan} is not a plan for {m} x {nc} {dt} lanes")
    defines = tuple(defines)
    check_bytes(plan, defines)
    status, obj, x, basis, at_upper, iters = out
    scratch = (torch.empty(B * plan.scratch_values, dtype=dt, device=dev)
               if plan.scratch_values else None)
    # the launch goes to the current device: W's, switched to only when it
    # is not
    index = device_index(dev)
    with torch.cuda.device(index) if index != torch.cuda.current_device() else nullcontext():
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib(defines).simplex_dense_launch(
            plan.dsize, W.data_ptr(), m, n, B,
            c.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            None if active is None else active.data_ptr(),
            int(max_iters), float(feas_tol), float(cost_tol), float(pivot_tol),
            float(progress_tol), int(stall_limit),
            plan.code, plan.C, plan.threads, plan.P,
            None if scratch is None else scratch.data_ptr(),
            status.data_ptr(), obj.data_ptr(), x.data_ptr(),
            basis.data_ptr(), at_upper.data_ptr(), iters.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"K5 launch of {plan} failed: CUDA error {err}")
    LAUNCHES[KERNEL] += 1
    if plan_launches is not None:
        plan_launches[plan.shape, plan.C, plan.P] += 1
    return out

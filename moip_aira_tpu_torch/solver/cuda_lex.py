"""K6, the lex backend's whole batch on the card, its launch plan and its
wrapper.

K6 (``csrc/lex_bnb.cu``) runs ``lex_torch.LexKernel``'s batch in one
launch, in float64: for each lane, the stages of its objective permutation,
each a depth-first branch and bound whose every node is a cold solve of
K5's loop (``csrc/simplex_dense_core.cuh``) inside the same kernel, with
every decision in the plain version's order of operations, so its outputs,
and each lane's count of nodes and LP steps, equal the plain version's on
the CPU.  It is no port of a Pallas kernel: the JAX package runs this batch
(``moip_aira_tpu/solver/lex_jax.py``) as one XLA program.  Its plain
version is ``LexKernel``'s loop on CPU tensors, and ``LexKernel.__call__``
on a CUDA device launches it through ``launch_lex_bnb``, once a call.

The launch plan (``lex_plan_for``) takes K6's own shape, ``regs`` (a warp
a lane, P lanes a block, the node's whole LP in the warp's registers and
no shared memory), for an LP of at most REGS_ROWS rows and REGS_COLS
columns, one a thread (``regs_takes``: G3KP10); then its second,
``regs_block`` (a block of ``windows(nc)`` warps a lane, the node's whole
LP in the block's registers, one column a thread, warp w holding window w
of the padded sums), for an LP of at most REGS_BLOCK_ROWS rows and 33 to
REGS_BLOCK_COLS columns (``regs_block_takes``: G2AP05, G3AP05, 3AP10).
Else the plan is K5's (``cuda_dense.dense_loop_plan``: ``packed``,
a warp a lane; ``block``; ``cluster`` of C blocks, each a slice of the
columns; last, ``global``, the slices in a global scratch) over the plans
that fit K6's own shared bytes (``lex_bnb_smem_bytes``: K5's, and the
node's rows, x, the warps' and the cluster's winners), so a plan that fits
K5 may not fit K6.  K5 never takes ``regs`` or ``regs_block``.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from contextlib import nullcontext
from dataclasses import dataclass
from typing import ClassVar, NamedTuple

import torch

from moip_aira_tpu_torch.kernels.build import load
from moip_aira_tpu_torch.solver.cuda_dense import (
    K5_MAX_PACK, K5_MAX_THREADS, K5_PACK_LANES, SHAPES, SPLIT, XLA_WINDOW, DenseLoopPlan,
    _seg, check_bytes, check_tensor, dense_loop_plan, dense_loop_smem_bytes, device_index,
    device_limits, plan_on, plans_that_fit, windows,
)
from moip_aira_tpu_torch.solver.cuda_lp import LAUNCHES

#: the kernel's name: its csrc/ source and its key in LAUNCHES
KERNEL = "lex_bnb"
#: bytes of a float64
F64 = 8
#: K6's shapes, by their code in csrc/lex_bnb.cu: K5's, then its own
LEX_SHAPES = SHAPES + ("regs", "regs_block")
#: the regs shape's largest LP: rows (the registers of a thread's tableau
#: column) and columns (one a thread of the warp)
REGS_ROWS = 16
REGS_COLS = 32
#: the regs_block shape's largest LP: rows (one a warp lane; the builds
#: keep 24 or 32 registers of a thread's tableau column) and columns (one
#: a thread of four warps); it takes more columns than a warp's threads
REGS_BLOCK_ROWS = 32
REGS_BLOCK_COLS = 4 * XLA_WINDOW
#: the regs_block shape's winner in a step's buffer: values before its
#: tableau column, and int32; a warp's copies of the rows' terms (t1, t2,
#: x_B and the two costs)
_RB_SLOT_T, _RB_SLOT_I, _RB_WARP_ROWS = 8, 3, 5


def regs_takes(m: int, n: int) -> bool:
    """Whether K6's regs shape takes an LP of m rows and n structural
    columns: m <= REGS_ROWS and n + m <= REGS_COLS (``regs_takes`` of
    csrc/lex_bnb.cu), the builds whose LP stays in registers with no
    spilled byte."""
    return 1 <= m <= REGS_ROWS and 0 <= n and n + m <= REGS_COLS


def regs_block_takes(m: int, n: int) -> bool:
    """Whether K6's regs_block shape takes an LP of m rows and n
    structural columns: m <= REGS_BLOCK_ROWS and 33 <= n + m <=
    REGS_BLOCK_COLS (``regs_block_takes`` of csrc/lex_bnb.cu)."""
    return 1 <= m <= REGS_BLOCK_ROWS and 0 <= n and XLA_WINDOW < n + m <= REGS_BLOCK_COLS


def regs_block_rows(m: int) -> int:
    """The rows of registers of the regs_block build that takes m rows."""
    return 24 if m <= 24 else REGS_BLOCK_ROWS


def lex_bnb_smem_bytes(shape: str, m: int, n: int, C: int, P: int) -> int:
    """A K6 block's dynamic shared bytes (``lex_layout`` of csrc/lex_bnb.cu;
    none in the regs shape), for one lane (P lanes in the packed shape):
    K5's (float64), then the node's rows c, lo and hi (n + m values each)
    and its x (n values), none of them in the global shape, whose rows lie
    in the global scratch; the warps' winners (eight warps of two values and
    an int32; none in the packed shape) and on a cluster the C blocks'
    published winners (two values and an int32 each), each array 16-byte
    aligned.  The regs_block shape keeps no tableau there, only its windows
    and warps' copies (``rb_layout``): the steps' two buffers of each warp's
    winner (8 values and its tableau column of ``regs_block_rows(m)``
    values; 3 int32), the start's windows of the basic values (a warp's
    ``regs_block_rows(m)``), the finish's windows of the objective and most
    fractional columns (3 values and an int32 a warp), and each warp's
    copies of the rows' five terms (``regs_block_rows(m)`` each) and of its
    32 columns' objective terms."""
    if shape == "regs":
        return 0
    if shape == "regs_block":
        nw, mr = windows(n + m), regs_block_rows(m)
        return sum(_seg(p) for p in (2 * nw * (_RB_SLOT_T + mr) * F64, 2 * nw * _RB_SLOT_I * 4,
                                     nw * mr * F64, nw * 3 * F64, nw * 4,
                                     nw * (_RB_WARP_ROWS * mr + XLA_WINDOW) * F64))
    nc = n + m
    glob = shape == "global"
    warps = 0 if shape == "packed" else K5_MAX_THREADS // 32
    mail = C if shape in SPLIT else 0
    row = 0 if glob else nc * F64
    parts = [row, row, row, 0 if glob else n * F64, 2 * warps * F64, warps * 4,
             2 * mail * F64, mail * 4]
    lane = dense_loop_smem_bytes(shape, m, nc, C, 1, F64) + sum(_seg(p) for p in parts)
    return P * lane if shape == "packed" else lane


@dataclass(frozen=True)
class LexPlan(DenseLoopPlan):
    """One K6 launch: K5's plan fields (float64) with K6's shared bytes."""

    KERNEL: ClassVar[str] = "K6"

    @property
    def code(self) -> int:
        return LEX_SHAPES.index(self.shape)

    @property
    def layout(self) -> str:
        if self.shape == "regs":
            return f"{self.P} x T in registers"
        if self.shape == "regs_block":
            return f"T in registers, {self.threads // 32} warps"
        return super().layout

    @property
    def smem_bytes(self) -> int:
        return lex_bnb_smem_bytes(self.shape, self.m, self.nc - self.m, self.C, self.P)

    @classmethod
    def pick(cls, m: int, nc: int, dtype, lanes: int, smem_cap: int, sms: int,
             held) -> "LexPlan":
        """K6's rule (``lex_plan_for``, float64), which
        ``cuda_dense.plan_on`` applies on a card."""
        return lex_plan_for(m, nc - m, lanes, smem_cap, sms, held)

    @property
    def row_values(self) -> int:
        """The global scratch's node rows a lane: c, lo, hi and x for each
        of its C blocks (0 but for the global shape)."""
        n = self.nc - self.m
        return self.C * (3 * self.nc + n) if self.shape == "global" else 0

    def kernel_smem_bytes(self, defines: tuple = ()) -> int:
        return _lib().lex_bnb_smem_bytes(self.code, self.m, self.nc - self.m, self.C, self.P)

    def kernel_clusters(self) -> int:
        return _lib().lex_bnb_max_clusters(
            self.code, self.m, self.nc - self.m, self.C, self.threads, self.P
        )

    def kernel_attrs(self) -> tuple:
        """(registers a thread, local bytes a thread) of the build the plan
        launches, as nvcc left it (``cudaFuncGetAttributes``): no local byte
        means no spill; raises for a plan the kernel refuses."""
        regs, local = ctypes.c_int(0), ctypes.c_int(0)
        err = _lib().lex_bnb_attrs(self.code, self.m, self.nc - self.m, self.C, self.threads,
                                   self.P, ctypes.byref(regs), ctypes.byref(local))
        if err != 0:
            raise RuntimeError(f"K6's build for {self}: CUDA error {err}")
        return regs.value, local.value


@functools.lru_cache(maxsize=None)
def regs_plan(m: int, n: int, P: int = K5_PACK_LANES) -> LexPlan:
    """K6's regs launch, P lanes (warps) a block; raises ValueError for an
    LP it does not take."""
    if not regs_takes(m, n) or not 1 <= P <= K5_MAX_PACK:
        raise ValueError(f"K6's regs shape takes no LP of {m} rows and {n + m} columns, "
                         f"{P} a block")
    return LexPlan(m, n + m, F64, "regs", 1, 32 * P, P)


@functools.lru_cache(maxsize=None)
def regs_block_plan(m: int, n: int) -> LexPlan:
    """K6's regs_block launch: a block of ``windows(n + m)`` warps a lane;
    raises ValueError for an LP it does not take."""
    if not regs_block_takes(m, n):
        raise ValueError(f"K6's regs_block shape takes no LP of {m} rows and {n + m} columns")
    return LexPlan(m, n + m, F64, "regs_block", 1, 32 * windows(n + m), 1)


def lex_plan_for(m: int, n: int, lanes: int, smem_cap: int, sms: int, held) -> LexPlan:
    """K6's launch for ``lanes`` lex lanes of an LP of m rows and n
    structural columns: ``regs_plan`` where ``regs_takes`` the LP, else
    ``regs_block_plan`` where ``regs_block_takes`` it, else K5's rule
    (``cuda_dense.dense_loop_plan``) over the plans that fit K6's shared
    bytes; ``held[C]`` are the clusters of C blocks (1: blocks) of each
    plan the card holds at once."""
    if regs_takes(m, n):
        return regs_plan(m, n)
    if regs_block_takes(m, n):
        return regs_block_plan(m, n)
    return dense_loop_plan(m, n + m, torch.float64, lanes, smem_cap, sms, held, LexPlan)


def lex_plans_that_fit(m: int, n: int, smem_cap: int) -> list:
    """Every plan K6 can launch for the shape: K5's that fit K6's shared
    bytes, then regs at P = 1, 2, 4 and 8 where it takes the LP, and
    regs_block where it takes the LP."""
    out = plans_that_fit(m, n + m, torch.float64, smem_cap, LexPlan)
    out += [regs_plan(m, n, P) for P in (1, 2, 4, 8)] if regs_takes(m, n) else []
    return out + ([regs_block_plan(m, n)] if regs_block_takes(m, n) else [])


class LexOut(NamedTuple):
    """K6's outputs, on the card: each lane's lex status, results, IPs,
    and its B&B nodes and LP steps over all its stages."""

    status: torch.Tensor
    results: torch.Tensor
    ips: torch.Tensor
    nodes: torch.Tensor
    iters: torch.Tensor


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.lex_bnb_smem_bytes.argtypes = [ci] * 5
    lib.lex_bnb_smem_bytes.restype = ctypes.c_longlong
    lib.lex_bnb_max_clusters.argtypes = [ci] * 6
    lib.lex_bnb_max_clusters.restype = ci
    lib.lex_bnb_attrs.argtypes = [ci] * 6 + [ctypes.POINTER(ci)] * 2
    lib.lex_bnb_attrs.restype = ci
    lib.lex_bnb_launch.argtypes = [
        vp, ci, ci, ci, ci,  # W, m, n, k, batch
        vp, vp, vp, vp, vp, vp, vp, vp, vp,  # rhs, perm, C, lb, ub, row_lb, row_ub, is_int, obj_integral
        ci, ci, ci, ci,  # is_min, maxn, max_bnb_nodes, max_iters
        cd, cd, cd, cd, ci,  # the four tolerances, stall_limit
        ci, ci, ci, ci,  # the plan: shape, C, threads, P
        vp, vp, vp,  # stack, the global shape's tableau slices and rows
        vp, vp, vp, vp, vp,  # status, results, ips, nodes, iters
        vp,  # stream
    ]
    lib.lex_bnb_launch.restype = ci
    return lib


@functools.lru_cache(maxsize=None)
def _lib(defines: tuple = ()) -> ctypes.CDLL:
    """K6's library (with extra ``-D`` flags: an instrumented variant beside
    the production one)."""
    return _bind(load(KERNEL, defines))


def lex_plan(W: torch.Tensor, lanes: int) -> LexPlan:
    """The launch ``lex_plan_for`` picks for ``lanes`` lanes over the
    system W = [A; C | -I] on W's card (worked out once per shape, card and
    lane count)."""
    m, nc = W.shape
    return plan_on(device_index(W.device), m, nc, torch.float64, int(lanes), LexPlan)


def lex_plans(W: torch.Tensor) -> list:
    """Every plan K6 can launch for the system W on W's card."""
    m, nc = W.shape
    return lex_plans_that_fit(m, nc - m, device_limits(device_index(W.device))[0])


def launch_lex_bnb(
    W: torch.Tensor, rhs, perm, C, lb, ub, row_lb, row_ub, is_int, obj_integral,
    is_min: bool, maxn: int, max_bnb_nodes: int, max_iters: int, feas_tol: float,
    cost_tol: float, pivot_tol: float, progress_tol: float, stall_limit: int,
    plan: LexPlan | None = None, plan_launches: Counter | None = None, defines: tuple = (),
) -> LexOut:
    """K6 on the lanes (rhs (B, k) float64, perm (B, k) int64) of the
    problem whose system is W = [A; C | -I] (m, n + m), objectives C (k,
    n), bounds lb/ub (n), constraint rows' bounds row_lb/row_ub (m - k),
    integrality is_int (n) and obj_integral (k) (bool), all contiguous on
    W's card: ``LexOut``, on the card.  One launch on the current stream,
    of ``plan`` (default: ``lex_plan(W, B)``; ``defines``: of the library
    built with those ``-D`` flags), counted in LAUNCHES and, when
    given, in ``plan_launches`` by the plan's (shape, C, P); raises for CPU
    tensors, for inputs it refuses, for a plan of another shape and for a
    failed launch (a plan that does not fit is refused before it)."""
    dev = W.device
    if dev.type != "cuda":
        raise ValueError(f"K6 runs on a CUDA device, not {dev}")
    m, nc = W.shape
    n = nc - m
    B, k = rhs.shape if rhs.dim() == 2 else (-1, -1)
    f64 = torch.float64
    check_tensor("W", W, dev, f64, (m, nc))
    check_tensor("rhs", rhs, dev, f64, (B, k))
    check_tensor("perm", perm, dev, torch.int64, (B, k))
    check_tensor("C", C, dev, f64, (k, n))
    for name, t, size in (("lb", lb, n), ("ub", ub, n), ("row_lb", row_lb, m - k),
                          ("row_ub", row_ub, m - k)):
        check_tensor(name, t, dev, f64, (size,))
    check_tensor("is_int", is_int, dev, torch.bool, (n,))
    check_tensor("obj_integral", obj_integral, dev, torch.bool, (k,))
    if not (1 <= k <= m) or maxn < 1:
        raise ValueError(f"K6 takes k in [1, {m}] objectives and a stack of >= 1 rows")
    out = LexOut(
        torch.empty(B, dtype=torch.int32, device=dev),
        torch.empty(B, k, dtype=torch.int64, device=dev),
        torch.empty(B, dtype=torch.int32, device=dev),
        torch.empty(B, dtype=torch.int64, device=dev),
        torch.empty(B, dtype=torch.int64, device=dev),
    )
    if B == 0:
        return out
    if plan is None:
        plan = lex_plan(W, B)
    if not isinstance(plan, LexPlan) or (plan.m, plan.nc, plan.dsize) != (m, nc, F64):
        raise ValueError(f"{plan} is not a K6 plan for {m} x {nc} float64 lanes")
    check_bytes(plan)
    stack = torch.empty(B * 2 * maxn * n, dtype=f64, device=dev)
    tab = torch.empty(B * plan.scratch_values, dtype=f64, device=dev) if plan.scratch_values \
        else None
    rows = torch.empty(B * plan.row_values, dtype=f64, device=dev) if plan.row_values else None
    # the launch goes to the current device: W's, switched to only when it
    # is not
    index = device_index(dev)
    with torch.cuda.device(index) if index != torch.cuda.current_device() else nullcontext():
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib(tuple(defines)).lex_bnb_launch(
            W.data_ptr(), m, n, k, B,
            rhs.data_ptr(), perm.data_ptr(), C.data_ptr(), lb.data_ptr(), ub.data_ptr(),
            row_lb.data_ptr() if m > k else None, row_ub.data_ptr() if m > k else None,
            is_int.data_ptr(), obj_integral.data_ptr(),
            int(is_min), int(maxn), int(max_bnb_nodes), int(max_iters),
            float(feas_tol), float(cost_tol), float(pivot_tol), float(progress_tol),
            int(stall_limit),
            plan.code, plan.C, plan.threads, plan.P,
            stack.data_ptr(), None if tab is None else tab.data_ptr(),
            None if rows is None else rows.data_ptr(),
            *(t.data_ptr() for t in out), stream,
        )
    if err != 0:
        raise RuntimeError(f"K6 launch of {plan} failed: CUDA error {err}")
    LAUNCHES[KERNEL] += 1
    if plan_launches is not None:
        plan_launches[plan.shape, plan.C, plan.P] += 1
    return out

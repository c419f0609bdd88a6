"""K3 on the card: B&B fragments, a depth-first subtree per lane.

The counterpart of ``moip_aira_tpu/solver/pallas_bb.py::make_pallas_bb_batch``:
kernel ``csrc/bb_fragment.cu``, plain version
``bb_torch.fragment_batch_ref``, wrapper ``make_cuda_bb_batch``.  The
callable it returns takes ``(c, lo, hi, par, wb=None, wa=None)`` and returns
the dict of ``solve_fragments`` (``pallas_bb.py:1166-1179``): ``best``,
``bestx``, ``nlog``, ``lstate``, ``iters``, ``ticks`` (each lane's own tick
count), the logs ``lg_scal``, ``lg_basis``, ``lg_atup`` (at-upper flags
packed 32 to an int32 word), ``fin_basis``, ``fin_atup`` and the records
compacted into ``(CAP, .)`` buffers
``lg_cscal``/``lg_cbasis``/``lg_catup``: each lane's first ``nlog`` records
at offset ``cumsum(nlog) - nlog`` (``MOIP_FRAG_CAP`` rows; when more records
than that were logged the host reads the full logs instead).

Each lane runs on a cluster of C blocks, C and the shared-memory layout
chosen per launch by ``bb_launch_plan`` from the shape, the lane count and
the clusters the card holds, as K2's ``rev_launch_plan`` chooses them.

Like the LP wrappers (solver/cuda_lp.py) it works by the device of the
tensors it is given: on CUDA tensors it launches K3, on CPU tensors it runs
the plain version, and nothing lets one continue on the other."""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from dataclasses import dataclass

import numpy as np
import torch

from moip_aira_tpu_torch.kernels.build import load
from moip_aira_tpu_torch.solver.bb_torch import (
    N_FIELDS,
    FragmentOutcome,
    fragment_batch_ref,
    packed_words,
    stall_exits,
    unpack_atup_np,
)
from moip_aira_tpu_torch.solver.cuda_lp import (
    LAUNCHES,
    REV_MAX_THREADS,
    STATIC_SMEM_RESERVE,
    cluster_sizes_for,
    pick_cluster,
)
from moip_aira_tpu_torch.utils import knobs

#: float vectors of m entries a K3 lane keeps (ROW_VECTORS of
#: csrc/bb_fragment.cu)
BB_ROW_VECTORS = 10


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    pi = ctypes.POINTER(ci)
    lib.bb_fragment_device_limits.argtypes = [pi, pi]
    lib.bb_fragment_device_limits.restype = ci
    lib.bb_fragment_smem_bytes.argtypes = [ci] * 8
    lib.bb_fragment_smem_bytes.restype = ctypes.c_longlong
    lib.bb_fragment_scratch_bytes.argtypes = [ci] * 5
    lib.bb_fragment_scratch_bytes.restype = ctypes.c_longlong
    lib.bb_fragment_max_clusters.argtypes = [ci] * 9
    lib.bb_fragment_max_clusters.restype = ci
    lib.bb_fragment_launch.argtypes = [
        vp, vp, ci, ci, ci,  # W, intm, m, n, batch
        vp, vp, vp, vp, vp, vp,  # c, lo, hi, par, wb, wa
        ci, ci, ci, ci, ci, ci,  # F, D, node_iters, max_ticks, stall exits
        cf, cf, cf,  # feas_tol, cost_tol, pivot_tol
        ci, ci, ci, ci, ci, ci,  # the plan: C, threads, B^-1, W, bounds, P1
        vp,  # scratch
        vp, vp, vp, vp, vp, vp,  # best, bestx, nlog, lstate, iters, ticks
        vp, vp, vp, vp, vp,  # lg_scal, lg_basis, lg_atup, fin_basis, fin_atup
        vp,  # stream
    ]
    lib.bb_fragment_launch.restype = ci
    return lib


@functools.lru_cache(maxsize=None)
def _bb_fragment_lib(defines: tuple = ()) -> ctypes.CDLL:
    """K3's library; ``defines`` (``-D`` flags) build an instrumented
    variant beside the production one (tools/k3_cluster_bench.py)."""
    return _bind(load("bb_fragment", defines))


def bb_smem_bytes(m: int, nc: int, D: int, C: int, bi_smem: bool, w_smem: bool,
                  col_smem: bool, p1_smem: bool) -> int:
    """A K3 block's dynamic shared bytes (``bb_smem_bytes`` of
    csrc/bb_fragment.cu): the m-vectors, the stack of D entries and the
    rebuild's masks, plus B^-1 (m x m f32), the block's W slice (m x
    ceil(nc / C) f32), the node bounds and flags (10 bytes a column) and
    the warm block P1 (m x m f32) where the plan keeps them there; 16-byte
    aligned."""
    b = 4 * (BB_ROW_VECTORS * m + 3 * D) + 4 * (2 * m + D) + 2 * D + 2 * m
    b += 4 * m * m if bi_smem else 0
    b += 4 * m * -(-nc // C) if w_smem else 0
    b += 10 * nc if col_smem else 0
    b += 4 * m * m if p1_smem else 0
    return (b + 15) & ~15


def bb_scratch_bytes(m: int, nc: int, bi_smem: bool, col_smem: bool, p1_smem: bool) -> int:
    """A K3 block's global scratch bytes (``bb_scratch_bytes`` of
    csrc/bb_fragment.cu): z and its non-zero columns (8 bytes a column),
    and what the plan keeps out of shared memory."""
    b = 8 * nc
    b += 0 if bi_smem else 4 * m * m
    b += 0 if p1_smem else 4 * m * m
    b += 0 if col_smem else 10 * nc
    return (b + 15) & ~15


@dataclass(frozen=True)
class BBPlan:
    """One K3 launch: C blocks of ``threads`` threads per lane, and which
    of B^-1, the block's W slice, the node bounds and flags, and the warm
    block P1 sit in shared memory."""

    m: int
    nc: int
    D: int
    C: int
    threads: int
    bi_smem: bool
    w_smem: bool
    col_smem: bool
    p1_smem: bool

    @property
    def width(self) -> int:
        """Columns a block prices: block r [r * width, r * width + width),
        cut at nc."""
        return -(-self.nc // self.C)

    @property
    def slices(self) -> tuple:
        w = self.width
        return tuple((min(self.nc, r * w), min(self.nc, r * w + w)) for r in range(self.C))

    @property
    def smem_bytes(self) -> int:
        return bb_smem_bytes(self.m, self.nc, self.D, self.C, self.bi_smem,
                             self.w_smem, self.col_smem, self.p1_smem)

    @property
    def scratch_bytes(self) -> int:
        """Global scratch bytes of one block."""
        return bb_scratch_bytes(self.m, self.nc, self.bi_smem, self.col_smem, self.p1_smem)

    @property
    def layout(self) -> str:
        """What shared memory holds, e.g. "B^-1+W+bounds+P1"; "-" for
        nothing beyond the vectors and the stack."""
        parts = [
            name for name, on in (
                ("B^-1", self.bi_smem), ("W", self.w_smem),
                ("bounds", self.col_smem), ("P1", self.p1_smem),
            ) if on
        ]
        return "+".join(parts) or "-"


def bb_plan_for(m: int, n: int, D: int, C: int, smem_bytes: int) -> BBPlan:
    """K3's launch with clusters of C blocks on a card whose blocks may opt
    into ``smem_bytes`` of shared memory.  Shared memory takes, in this
    order, each part that still fits beside the ones before it: B^-1 (every
    pivot reads it three times), the block's W slice (pricing reads it
    once a pivot), the node bounds and flags (pricing reads them once a
    pivot, the node transitions a few times a node), the warm block P1
    (read by the root's rebuild only); nothing but B^-1 comes first.  The
    block size is K2's rule (``rev_plan_for``).  Raises ValueError when not
    even the m-vectors and the stack fit."""
    nc = n + m
    cap = smem_bytes - STATIC_SMEM_RESERVE

    def fits(*parts):
        return bb_smem_bytes(m, nc, D, C, *parts) <= cap

    if not fits(False, False, False, False):
        raise ValueError(f"K3 cannot take an LP of {m} rows and {nc} columns with a stack of {D}")
    bi = fits(True, False, False, False)
    w = bi and fits(True, True, False, False)
    col = bi and fits(True, w, True, False)
    p1 = bi and fits(True, w, col, True)
    width = -(-nc // C)
    want = max(width, 2 * 32 * -(-m // 32) + 64, -(-m * m // 8))
    return BBPlan(m, nc, D, C, min(REV_MAX_THREADS, 32 * -(-want // 32)), bi, w, col, p1)


def bb_launch_plan(m: int, n: int, D: int, lanes: int, smem_bytes: int, sms: int,
                   held) -> BBPlan:
    """K3's launch for ``lanes`` subtrees of LPs of m rows and n structural
    columns with a stack of D entries, on a card of ``sms`` SMs whose
    blocks may opt into ``smem_bytes`` of shared memory and which holds
    ``held[C]`` clusters of C blocks at once: K2's rule (``pick_cluster``),
    the smallest C whose W slice fits in shared memory beside K3's state
    while the card holds a cluster for every lane, else the largest C at
    which it holds them all.  Reckoned for the H100: 2AP20 and G3KP10 take
    C = 1 with all of W in shared memory, 2AP40 C = 4 up to the clusters of
    four the card holds.  Raises ValueError when the shape does not fit."""
    sizes = cluster_sizes_for(n + m)
    plans = {C: bb_plan_for(m, n, D, C, smem_bytes) for C in sizes}
    fits = [C for C in sizes if plans[C].w_smem]
    return plans[pick_cluster(sizes, fits, max(lanes, 1), sms, held)]


@functools.lru_cache(maxsize=None)
def _bb_max_clusters(device: int, plan: BBPlan) -> int:
    with torch.cuda.device(device):
        got = _bb_fragment_lib().bb_fragment_max_clusters(
            plan.m, plan.nc - plan.m, plan.D, plan.C, plan.threads,
            int(plan.bi_smem), int(plan.w_smem), int(plan.col_smem), int(plan.p1_smem),
        )
    if got < 0:
        raise RuntimeError(f"K3: occupancy of {plan} failed: CUDA error {-got}")
    return got


class CudaBBBatch:
    """K3 over one system matrix ``W`` (m, n + m) with integer structural
    columns ``int_mask``, one cluster of blocks per lane as
    ``bb_launch_plan`` says.  ``launches`` counts the kernel launches this
    object made, ``cluster_sizes`` them by C, ``launch_lanes`` by (C,
    lanes)."""

    #: the kernel's name: its csrc/ source and its key in LAUNCHES
    kernel = "bb_fragment"
    #: extra -D flags of the build this object launches (an instrumented
    #: variant of tools/k3_cluster_bench.py; empty in production)
    defines: tuple = ()

    def __init__(
        self,
        W_dev: torch.Tensor,
        int_mask,
        device: torch.device,
        F: int = 32,
        D: int = 128,
        node_iters: int = 1500,
        max_ticks: int = 8192,
        feas_tol: float = 3e-4,
        cost_tol: float = 3e-5,
        pivot_tol: float = 3e-5,
    ):
        self.W = W_dev.to(device=torch.device(device), dtype=torch.float32).contiguous()
        #: W's device (a CPU named with an index is the CPU all the same)
        self.device = self.W.device
        self.m, nc = self.W.shape
        self.n = nc - self.m
        self.int_mask = np.asarray(int_mask, dtype=np.float32)[: self.n].copy()
        intm = np.zeros(nc, dtype=np.float32)
        intm[: self.int_mask.shape[0]] = self.int_mask
        self.intm = torch.as_tensor(intm, device=self.device)
        self.F, self.D = int(F), int(D)
        self.node_iters = int(node_iters)
        self.max_ticks = int(max_ticks)
        self.stall_exit, self.p1_stall = stall_exits(self.node_iters)
        self.feas_tol = float(feas_tol)
        self.cost_tol = float(cost_tol)
        self.pivot_tol = float(pivot_tol)
        self.cap = int(knobs.get("MOIP_FRAG_CAP"))
        self.launches = 0
        self.cluster_sizes: Counter = Counter()
        self.launch_lanes: Counter = Counter()
        unpack = functools.partial(unpack_atup_np, nc=nc)
        self.meta = dict(
            m=self.m, nc=nc, n=self.n, F=self.F, D=self.D, PW=packed_words(nc),
            cap=self.cap,
            # (B, F, PW) and (B, PW) words -> (B, F, nc) and (B, nc) flags
            unpack_atup=unpack, unpack_atup1=unpack,
        )

    def __call__(self, c, lo, hi, par, wb=None, wa=None) -> dict:
        B = c.shape[0]
        if wb is None:
            wb = torch.full((B, self.m), -1, dtype=torch.int32, device=c.device)
            wa = torch.zeros((B, self.n + self.m), dtype=torch.int32, device=c.device)
        self._check(c, lo, hi, par, wb, wa)
        if c.device.type == "cuda":
            raw = self._launch(c, lo, hi, par, wb, wa)
        elif c.device.type == "cpu":
            raw = fragment_batch_ref(
                self.W, self.int_mask, c, lo, hi, par, wb, wa,
                F=self.F, D=self.D, node_iters=self.node_iters,
                max_ticks=self.max_ticks, feas_tol=self.feas_tol,
                cost_tol=self.cost_tol, pivot_tol=self.pivot_tol,
                p1_stall=self.p1_stall,
            )
        else:
            raise ValueError(f"no {self.kernel} kernel for device {c.device}")
        return self._result(raw)

    def run(self, c, lo, hi, par, wb, wa, plan: BBPlan) -> dict:
        """Launch K3 with the given plan instead of the chosen one (to
        measure plans against each other); CUDA tensors only."""
        self._check(c, lo, hi, par, wb, wa)
        if c.device.type != "cuda":
            raise ValueError("a launch plan needs CUDA tensors")
        return self._result(self._launch(c, lo, hi, par, wb, wa, plan))

    def _result(self, raw: FragmentOutcome) -> dict:
        out = raw._asdict()
        out.update(self._compact(raw))
        return out

    @functools.cached_property
    def device_limits(self) -> tuple:
        """(shared bytes a block may opt into, SMs) of this object's card."""
        smem, sms = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(self.device):
            err = _bb_fragment_lib().bb_fragment_device_limits(
                ctypes.byref(smem), ctypes.byref(sms)
            )
        if err != 0:
            raise RuntimeError(f"K3: reading the card's limits failed: CUDA error {err}")
        return smem.value, sms.value

    @functools.cached_property
    def held(self) -> dict:
        """Clusters of each size C the card holds at once, each under the
        plan ``bb_plan_for`` gives that C."""
        smem, _ = self.device_limits
        return {
            C: self.max_clusters(bb_plan_for(self.m, self.n, self.D, C, smem))
            for C in cluster_sizes_for(self.n + self.m)
        }

    def plan(self, lanes: int) -> BBPlan:
        """The launch ``bb_launch_plan`` picks for ``lanes`` lanes here."""
        return bb_launch_plan(self.m, self.n, self.D, lanes, *self.device_limits, self.held)

    def max_clusters(self, plan: BBPlan) -> int:
        """How many clusters of ``plan`` the card holds at once (asked once
        per plan and device)."""
        return _bb_max_clusters(self.device.index or 0, plan)

    def _check(self, c, lo, hi, par, wb, wa) -> None:
        m, nc = self.m, self.n + self.m
        B = c.shape[0]
        for name, t, dt, shape in (
            ("c", c, torch.float32, (B, nc)),
            ("lo", lo, torch.float32, (B, nc)),
            ("hi", hi, torch.float32, (B, nc)),
            ("par", par, torch.float32, (B, 4)),
            ("wb", wb, torch.int32, (B, m)),
            ("wa", wa, torch.int32, (B, nc)),
        ):
            if t.device != self.device:
                raise ValueError(f"{name} lies on {t.device}, the solver on {self.device}")
            if t.dtype != dt:
                raise TypeError(f"{name} must be {dt}, got {t.dtype}")
            if tuple(t.shape) != shape:
                raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")

    def _compact(self, raw: FragmentOutcome) -> dict:
        """Each lane's first nlog records, densely at offset
        cumsum(nlog) - nlog, in (CAP, .) buffers; the unused slots and the
        records past CAP land in a dropped trash row (the host then reads
        the full logs).  Nothing here waits for the card."""
        F, cap = self.F, self.cap
        nl = raw.nlog.clamp(max=F).long()
        off = torch.cumsum(nl, 0) - nl
        fidx = torch.arange(F, device=nl.device)[None, :]
        valid = fidx < nl[:, None]
        dest = torch.where(valid, off[:, None] + fidx, cap).clamp(max=cap).flatten()

        def squeeze(log):
            tail = tuple(log.shape[2:])
            buf = torch.zeros((cap + 1,) + tail, dtype=log.dtype, device=log.device)
            buf.index_put_((dest,), log.reshape((-1,) + tail))
            return buf[:cap]

        return dict(
            lg_cscal=squeeze(raw.lg_scal),
            lg_cbasis=squeeze(raw.lg_basis),
            lg_catup=squeeze(raw.lg_atup),
        )

    def _launch(self, c, lo, hi, par, wb, wa, plan=None) -> FragmentOutcome:
        lib = _bb_fragment_lib(self.defines)
        m, n, F = self.m, self.n, self.F
        nc = n + m
        pw = packed_words(nc)
        B = c.shape[0]
        dev = self.device

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        out = FragmentOutcome(
            best=zeros(B, dtype=torch.float32),
            bestx=zeros(B, nc, dtype=torch.float32),
            nlog=zeros(B),
            lstate=zeros(B),
            iters=zeros(B),
            ticks=zeros(B),
            lg_scal=zeros(B, F, N_FIELDS, dtype=torch.float32),
            lg_basis=zeros(B, F, m),
            lg_atup=zeros(B, F, pw),
            fin_basis=zeros(B, m),
            fin_atup=zeros(B, pw),
        )
        if B == 0:
            return out
        if plan is None:
            plan = self.plan(B)
        if (plan.m, plan.nc, plan.D) != (m, nc, self.D):
            raise ValueError(f"{plan} is not a plan for {m} rows, {nc} columns and D = {self.D}")
        flags = (int(plan.bi_smem), int(plan.w_smem), int(plan.col_smem), int(plan.p1_smem))
        kb = lib.bb_fragment_smem_bytes(m, n, self.D, plan.C, *flags)
        if kb != plan.smem_bytes:
            raise RuntimeError(f"K3 counts {kb} shared bytes for {plan}, the plan {plan.smem_bytes}")
        block_bytes = lib.bb_fragment_scratch_bytes(m, n, flags[0], flags[2], flags[3])
        if block_bytes != plan.scratch_bytes:
            raise RuntimeError(
                f"K3 counts {block_bytes} scratch bytes a block for {plan}, the plan {plan.scratch_bytes}"
            )
        scratch = torch.empty(B * plan.C * block_bytes, dtype=torch.uint8, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.bb_fragment_launch(
                self.W.data_ptr(), self.intm.data_ptr(), m, n, B,
                c.data_ptr(), lo.data_ptr(), hi.data_ptr(), par.data_ptr(),
                wb.data_ptr(), wa.data_ptr(),
                F, self.D, self.node_iters, self.max_ticks,
                self.stall_exit, self.p1_stall,
                self.feas_tol, self.cost_tol, self.pivot_tol,
                plan.C, plan.threads, *flags,
                scratch.data_ptr(),
                *(t.data_ptr() for t in out),
                stream,
            )
        if err != 0:
            raise RuntimeError(f"K3 launch of {plan} failed: CUDA error {err}")
        self.launches += 1
        self.cluster_sizes[plan.C] += 1
        self.launch_lanes[plan.C, B] += 1
        LAUNCHES[self.kernel] += 1
        return out


def make_cuda_bb_batch(
    W_dev: torch.Tensor,
    int_mask,
    device: torch.device,
    F: int = 32,
    D: int = 128,
    node_iters: int = 1500,
    max_ticks: int = 8192,
    feas_tol: float = 3e-4,
    cost_tol: float = 3e-5,
    pivot_tol: float = 3e-5,
):
    """K3 for the system ``W_dev``: returns ``(fn, meta)`` as
    ``make_pallas_bb_batch`` does, ``fn`` being the ``CudaBBBatch``."""
    fn = CudaBBBatch(
        W_dev, int_mask, device, F=F, D=D, node_iters=node_iters,
        max_ticks=max_ticks, feas_tol=feas_tol, cost_tol=cost_tol,
        pivot_tol=pivot_tol,
    )
    return fn, fn.meta

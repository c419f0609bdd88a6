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

Like the LP wrappers (solver/cuda_lp.py) it works by the device of the
tensors it is given: on CUDA tensors it launches K3, on CPU tensors it runs
the plain version, and nothing lets one continue on the other."""

from __future__ import annotations

import ctypes
import functools

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
from moip_aira_tpu_torch.solver.cuda_lp import LAUNCHES
from moip_aira_tpu_torch.utils import knobs


@functools.lru_cache(maxsize=None)
def _bb_fragment_lib() -> ctypes.CDLL:
    lib = load("bb_fragment")
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bb_fragment_layout.argtypes = [ci, ci, ci]
    lib.bb_fragment_layout.restype = ci
    lib.bb_fragment_scratch_bytes.argtypes = [ci, ci, ci]
    lib.bb_fragment_scratch_bytes.restype = ctypes.c_longlong
    lib.bb_fragment_launch.argtypes = [
        vp, vp, ci, ci, ci,  # W, intm, m, n, batch
        vp, vp, vp, vp, vp, vp,  # c, lo, hi, par, wb, wa
        ci, ci, ci, ci, ci, ci,  # F, D, node_iters, max_ticks, stall exits
        cf, cf, cf,  # feas_tol, cost_tol, pivot_tol
        vp,  # scratch
        vp, vp, vp, vp, vp, vp,  # best, bestx, nlog, lstate, iters, ticks
        vp, vp, vp, vp, vp,  # lg_scal, lg_basis, lg_atup, fin_basis, fin_atup
        vp,  # stream
    ]
    lib.bb_fragment_launch.restype = ci
    return lib


class CudaBBBatch:
    """K3 over one system matrix ``W`` (m, n + m) with integer structural
    columns ``int_mask``; ``launches`` counts the kernel launches this
    object made."""

    #: the kernel's name: its csrc/ source and its key in LAUNCHES
    kernel = "bb_fragment"

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
        self.device = torch.device(device)
        self.W = W_dev.to(device=self.device, dtype=torch.float32).contiguous()
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
        out = raw._asdict()
        out.update(self._compact(raw))
        return out

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

    def _launch(self, c, lo, hi, par, wb, wa) -> FragmentOutcome:
        lib = _bb_fragment_lib()
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
        layout = lib.bb_fragment_layout(m, n, self.D)
        if layout < 0:
            raise ValueError(f"K3 cannot take an LP of {m} rows and {nc} columns")
        lane_bytes = lib.bb_fragment_scratch_bytes(layout, m, n)
        scratch = torch.empty(B * lane_bytes, dtype=torch.uint8, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.bb_fragment_launch(
                self.W.data_ptr(), self.intm.data_ptr(), m, n, B,
                c.data_ptr(), lo.data_ptr(), hi.data_ptr(), par.data_ptr(),
                wb.data_ptr(), wa.data_ptr(),
                F, self.D, self.node_iters, self.max_ticks,
                self.stall_exit, self.p1_stall,
                self.feas_tol, self.cost_tol, self.pivot_tol,
                scratch.data_ptr(),
                *(t.data_ptr() for t in out),
                stream,
            )
        if err != 0:
            raise RuntimeError(f"K3 launch failed: CUDA error {err}")
        self.launches += 1
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

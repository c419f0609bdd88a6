"""The batched LP kernels on the card, and their wrappers.

* K1, the dense-tableau simplex (counterpart of
  ``moip_aira_tpu/solver/pallas_lp.py``): kernel ``csrc/dense_simplex.cu``,
  plain version ``simplex_torch.dense_lp_batch_ref``, wrapper
  ``make_cuda_lp_batch``;
* K2, the revised simplex (counterpart of
  ``moip_aira_tpu/solver/pallas_rev.py``): kernel
  ``csrc/revised_simplex.cu``, plain version
  ``simplex_torch.revised_lp_batch_ref``, wrapper ``make_cuda_rev_batch``.

Both kernels run one thread block per LP lane.  Each wrapper returns a
callable with the unpacked contract of the Pallas builders
(``pack=False``): ``(c, lo, hi, wb, wa) -> LPOutcome(status, obj, x, basis,
at_upper, iters)``.

The callable works by the device of the tensors it is given: on CUDA tensors
it launches its kernel, on CPU tensors it runs the plain version.  It never
does both, and nothing lets a failed launch continue on the other."""

from __future__ import annotations

import ctypes
import functools

import torch

from moip_aira_tpu_torch.kernels.build import load
from moip_aira_tpu_torch.solver.simplex_torch import (
    LPOutcome,
    dense_lp_batch_ref,
    revised_lp_batch_ref,
)


#: launches of each kernel in this process, by kernel name (the wrappers'
#: own ``launches`` count per object; K3's wrapper is solver/cuda_bb.py,
#: K4's solver/cuda_dp.py); ``reset_launches`` zeroes them
LAUNCHES = {"dense_simplex": 0, "revised_simplex": 0, "bb_fragment": 0, "kp_dp": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _dense_simplex_lib() -> ctypes.CDLL:
    lib = load("dense_simplex")
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dense_simplex_tableau_in_smem.argtypes = [ci, ci]
    lib.dense_simplex_tableau_in_smem.restype = ci
    lib.dense_simplex_launch.argtypes = [
        vp, ci, ci, ci,  # W, m, n, batch
        vp, vp, vp, vp, vp,  # c, lo, hi, wb, wa
        ci, cf, cf, cf,  # max_iters, feas_tol, cost_tol, pivot_tol
        vp,  # T scratch
        vp, vp, vp, vp, vp, vp,  # status, obj, x, basis, at_upper, iters
        vp,  # stream
    ]
    lib.dense_simplex_launch.restype = ci
    return lib


@functools.lru_cache(maxsize=None)
def _revised_simplex_lib() -> ctypes.CDLL:
    lib = load("revised_simplex")
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.revised_simplex_layout.argtypes = [ci, ci]
    lib.revised_simplex_layout.restype = ci
    lib.revised_simplex_launch.argtypes = [
        vp, ci, ci, ci,  # W, m, n, batch
        vp, vp, vp, vp, vp,  # c, lo, hi, wb, wa
        ci, cf, cf, cf,  # max_iters, feas_tol, cost_tol, pivot_tol
        vp, vp, vp,  # B^-1, P1 and z scratch
        vp, vp, vp, vp, vp, vp,  # status, obj, x, basis, at_upper, iters
        vp,  # stream
    ]
    lib.revised_simplex_launch.restype = ci
    return lib


class CudaLPBatch:
    """K1: solves batches of LPs over one system matrix ``W`` (m, n + m).

    ``launches`` counts the kernel launches this object made."""

    #: the kernel's name: its csrc/ source, its key in LAUNCHES and the
    #: "kernel" of backend_stats
    kernel = "dense_simplex"
    plain = staticmethod(dense_lp_batch_ref)

    def __init__(
        self,
        W_dev: torch.Tensor,
        device: torch.device,
        max_iters: int = 2000,
        feas_tol: float = 3e-4,
        cost_tol: float = 3e-5,
        pivot_tol: float = 3e-5,
    ):
        self.device = torch.device(device)
        self.W = W_dev.to(device=self.device, dtype=torch.float32).contiguous()
        self.m, nc = self.W.shape
        self.n = nc - self.m
        self.max_iters = int(max_iters)
        self.feas_tol = float(feas_tol)
        self.cost_tol = float(cost_tol)
        self.pivot_tol = float(pivot_tol)
        self.launches = 0

    def __call__(self, c, lo, hi, wb, wa) -> LPOutcome:
        self._check(c, lo, hi, wb, wa)
        if c.device.type == "cuda":
            return self._launch(c, lo, hi, wb, wa)
        if c.device.type == "cpu":
            return self.plain(
                self.W, c, lo, hi, wb, wa,
                max_iters=self.max_iters, feas_tol=self.feas_tol,
                cost_tol=self.cost_tol, pivot_tol=self.pivot_tol,
                dtype=torch.float32,
            )
        raise ValueError(f"no {self.kernel} kernel for device {c.device}")

    def _check(self, c, lo, hi, wb, wa) -> None:
        m, n = self.m, self.n
        B = c.shape[0]
        for name, t, dt, shape in (
            ("c", c, torch.float32, (B, n + m)),
            ("lo", lo, torch.float32, (B, n + m)),
            ("hi", hi, torch.float32, (B, n + m)),
            ("wb", wb, torch.int32, (B, m)),
            ("wa", wa, torch.int32, (B, n + m)),
        ):
            if t.device != self.device:
                raise ValueError(
                    f"{name} lies on {t.device}, the solver on {self.device}"
                )
            if t.dtype != dt:
                raise TypeError(f"{name} must be {dt}, got {t.dtype}")
            if tuple(t.shape) != shape:
                raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")

    def _outputs(self, B) -> LPOutcome:
        m, n, dev = self.m, self.n, self.device
        return LPOutcome(
            torch.empty(B, dtype=torch.int32, device=dev),
            torch.empty(B, dtype=torch.float32, device=dev),
            torch.empty(B, n, dtype=torch.float32, device=dev),
            torch.empty(B, m, dtype=torch.int32, device=dev),
            torch.empty(B, n + m, dtype=torch.int32, device=dev),
            torch.empty(B, dtype=torch.int32, device=dev),
        )

    def _launch(self, c, lo, hi, wb, wa) -> LPOutcome:
        lib = _dense_simplex_lib()
        m, n = self.m, self.n
        B = c.shape[0]
        dev = self.device
        out = self._outputs(B)
        status, obj, x, basis, at_upper, iters = out
        if B == 0:
            return out
        where = lib.dense_simplex_tableau_in_smem(m, n)
        if where < 0:
            raise ValueError(f"K1 cannot take an LP of {m} rows and {n + m} columns")
        scratch = None
        if where == 0:
            scratch = torch.empty(B, m, n + m, dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.dense_simplex_launch(
                self.W.data_ptr(), m, n, B,
                c.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                wb.data_ptr(), wa.data_ptr(),
                self.max_iters, self.feas_tol, self.cost_tol, self.pivot_tol,
                scratch.data_ptr() if scratch is not None else None,
                status.data_ptr(), obj.data_ptr(), x.data_ptr(),
                basis.data_ptr(), at_upper.data_ptr(), iters.data_ptr(),
                stream,
            )
        if err != 0:
            raise RuntimeError(f"K1 launch failed: CUDA error {err}")
        self.launches += 1
        LAUNCHES[self.kernel] += 1
        return out


class CudaRevBatch(CudaLPBatch):
    """K2, the revised simplex: the same contract, checks and counter as
    K1's ``CudaLPBatch``."""

    kernel = "revised_simplex"
    plain = staticmethod(revised_lp_batch_ref)

    def _launch(self, c, lo, hi, wb, wa) -> LPOutcome:
        lib = _revised_simplex_lib()
        m, n = self.m, self.n
        B = c.shape[0]
        dev = self.device
        out = self._outputs(B)
        status, obj, x, basis, at_upper, iters = out
        if B == 0:
            return out
        layout = lib.revised_simplex_layout(m, n)
        if layout < 0:
            raise ValueError(f"K2 cannot take an LP of {m} rows and {n + m} columns")

        def square():
            return torch.empty(B, m, m, dtype=torch.float32, device=dev)

        bi_scratch = square() if layout < 1 else None
        p1_scratch = square() if layout < 2 else None
        z_scratch = torch.empty(B, n + m, dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.revised_simplex_launch(
                self.W.data_ptr(), m, n, B,
                c.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                wb.data_ptr(), wa.data_ptr(),
                self.max_iters, self.feas_tol, self.cost_tol, self.pivot_tol,
                bi_scratch.data_ptr() if bi_scratch is not None else None,
                p1_scratch.data_ptr() if p1_scratch is not None else None,
                z_scratch.data_ptr(),
                status.data_ptr(), obj.data_ptr(), x.data_ptr(),
                basis.data_ptr(), at_upper.data_ptr(), iters.data_ptr(),
                stream,
            )
        if err != 0:
            raise RuntimeError(f"K2 launch failed: CUDA error {err}")
        self.launches += 1
        LAUNCHES[self.kernel] += 1
        return out


def make_cuda_lp_batch(
    W_dev: torch.Tensor,
    device: torch.device,
    max_iters: int = 2000,
    feas_tol: float = 3e-4,
    cost_tol: float = 3e-5,
    pivot_tol: float = 3e-5,
) -> CudaLPBatch:
    """K1 for the system ``W_dev``; see ``CudaLPBatch``."""
    return CudaLPBatch(W_dev, device, max_iters, feas_tol, cost_tol, pivot_tol)


def make_cuda_rev_batch(
    W_dev: torch.Tensor,
    device: torch.device,
    max_iters: int = 2000,
    feas_tol: float = 3e-4,
    cost_tol: float = 3e-5,
    pivot_tol: float = 3e-5,
) -> CudaRevBatch:
    """K2 for the system ``W_dev``; see ``CudaRevBatch``."""
    return CudaRevBatch(W_dev, device, max_iters, feas_tol, cost_tol, pivot_tol)

"""K4 on the card: the bi-objective knapsack front DP, one launch per item.

The counterpart of ``moip_aira_tpu/solver/kp_front.py::front_pallas``:
kernel ``csrc/kp_dp.cu``, plain version ``kp_front.dp_table_ref``, wrapper
``CudaKPDP``.  Called with the expanded items ``(3, n)`` int32 (rows w, b,
a), the capacity and S, it returns the final ``(cap + 1, S + 1)`` int32
table on the items' device.  ``kp_front.front_cuda`` copies only its answer
row g[cap, 0:S+1] to the host.

Like the LP wrappers (solver/cuda_lp.py) it works by the device of the
tensor it is given: on a CUDA tensor it launches K4, on a CPU tensor it
runs the plain version, and nothing lets one continue on the other."""

from __future__ import annotations

import ctypes
import functools

import torch

from moip_aira_tpu_torch.kernels.build import load
from moip_aira_tpu_torch.solver.cuda_lp import LAUNCHES
from moip_aira_tpu_torch.solver.kp_front import MAX_TABLE_CELLS, dp_table_ref


@functools.lru_cache(maxsize=None)
def _kp_dp_lib() -> ctypes.CDLL:
    lib = load("kp_dp")
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.kp_dp_step_launch.argtypes = [
        vp, vp, ll, ll,  # in, out, rows, cols
        ll, ctypes.c_int, ll,  # w, b, a
        vp,  # stream
    ]
    lib.kp_dp_step_launch.restype = ctypes.c_int
    return lib


class CudaKPDP:
    """K4 over a whole item list; ``launches`` counts the kernel launches
    this object made (one per item)."""

    #: the kernel's name: its csrc/ source, its key in LAUNCHES and the
    #: "kernel" of backend_stats
    kernel = "kp_dp"
    plain = staticmethod(dp_table_ref)

    def __init__(self):
        self.launches = 0

    def __call__(self, items: torch.Tensor, cap: int, S: int) -> torch.Tensor:
        self._check(items, cap, S)
        if items.device.type == "cuda":
            return self._launch(items, cap, S)
        if items.device.type == "cpu":
            return self.plain(items, cap, S)
        raise ValueError(f"no {self.kernel} kernel for device {items.device}")

    @staticmethod
    def _check(items, cap, S) -> None:
        if items.dtype != torch.int32:
            raise TypeError(f"items must be torch.int32, got {items.dtype}")
        if items.dim() != 2 or items.shape[0] != 3:
            raise ValueError(f"items must have shape (3, n), got {tuple(items.shape)}")
        if not items.is_contiguous():
            raise ValueError("items must be contiguous")
        if cap < 0 or S < 0:
            raise ValueError(f"cap and S must be >= 0, got {cap} and {S}")
        if (cap + 1) * (S + 1) > MAX_TABLE_CELLS:
            raise ValueError(
                f"a {cap + 1} x {S + 1} table exceeds {MAX_TABLE_CELLS} cells"
            )

    def _launch(self, items, cap, S) -> torch.Tensor:
        lib = _kp_dp_lib()
        dev = items.device
        host = items.cpu()
        if bool((host[0] < 0).any()) or bool((host[2] < 0).any()):
            raise ValueError("K4 takes items of weight and s-value >= 0")
        rows, cols = cap + 1, S + 1
        cur = torch.full((rows, cols), -1, dtype=torch.int32, device=dev)
        cur[:, 0] = 0
        nxt = torch.empty_like(cur)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            for w, b, a in host.t().tolist():
                err = lib.kp_dp_step_launch(
                    cur.data_ptr(), nxt.data_ptr(), rows, cols, w, b, a, stream
                )
                if err != 0:
                    raise RuntimeError(f"K4 launch failed: CUDA error {err}")
                self.launches += 1
                LAUNCHES[self.kernel] += 1
                cur, nxt = nxt, cur
        return cur

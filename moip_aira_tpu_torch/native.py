"""ctypes binding for the native C++ runtime components (native/moip_native.cpp).

The reference's runtime is C++ end-to-end; here the host-side hot paths — the
Pareto/relaxation store scan and the branch-and-bound node pool — have native
implementations, loaded lazily.  Everything degrades gracefully to the NumPy
implementations when the shared library has not been built
(``make -C native``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

from moip_aira_tpu_torch.sense import Sense
from moip_aira_tpu_torch.utils.trace import counted

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_c_double_p = ctypes.POINTER(ctypes.c_double)
_c_int64_p = ctypes.POINTER(ctypes.c_int64)
_c_uint8_p = ctypes.POINTER(ctypes.c_uint8)
_c_int_p = ctypes.POINTER(ctypes.c_int)


def _lib_path() -> str:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(here, "native", "libmoip_native.so")


def build_native(quiet: bool = True) -> bool:
    """Build the shared library with make; returns True on success."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        subprocess.run(
            ["make", "-C", os.path.join(here, "native")],
            check=True,
            capture_output=quiet,
        )
        return True
    except Exception:
        return False


def load_native(auto_build: bool = True) -> Optional[ctypes.CDLL]:
    """Load (and optionally build) the native library; None if unavailable."""
    global _LIB, _TRIED
    if _LIB is not None or (_TRIED and not auto_build):
        return _LIB
    _TRIED = True
    path = _lib_path()
    if not os.path.exists(path) and auto_build:
        build_native()
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None

    lib.moip_store_create.restype = ctypes.c_void_p
    lib.moip_store_create.argtypes = [ctypes.c_int]
    lib.moip_store_destroy.argtypes = [ctypes.c_void_p]
    lib.moip_store_size.restype = ctypes.c_int64
    lib.moip_store_size.argtypes = [ctypes.c_void_p]
    lib.moip_store_insert.argtypes = [
        ctypes.c_void_p, _c_double_p, _c_int64_p, ctypes.c_int,
    ]
    lib.moip_store_find.restype = ctypes.c_int64
    lib.moip_store_find.argtypes = [
        ctypes.c_void_p, _c_double_p, ctypes.c_int, _c_int64_p, _c_int_p,
    ]
    lib.moip_store_find_batch.argtypes = [
        ctypes.c_void_p, _c_double_p, ctypes.c_int64, ctypes.c_int,
        _c_uint8_p, _c_uint8_p, _c_int64_p,
    ]
    lib.moip_store_merge.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.moip_store_sorted_unique.restype = ctypes.c_int64
    lib.moip_store_sorted_unique.argtypes = [
        ctypes.c_void_p, _c_int64_p, ctypes.c_int64,
    ]
    _LIB = lib
    return _LIB


class NativeSolutions:
    """Drop-in twin of core.store.Solutions backed by the C++ store."""

    def __init__(self, objective_count: int, lib: Optional[ctypes.CDLL] = None):
        self._lib = lib or load_native()
        if self._lib is None:
            raise RuntimeError("native library unavailable (make -C native)")
        self.objective_count = objective_count
        self._h = self._lib.moip_store_create(objective_count)

    def __del__(self):
        lib = getattr(self, "_lib", None)
        h = getattr(self, "_h", None)
        if lib is not None and h:
            lib.moip_store_destroy(h)
            self._h = None

    def __len__(self) -> int:
        return int(self._lib.moip_store_size(self._h))

    @counted("store.insert")
    def insert(self, ip, result, infeasible: bool) -> None:
        ip = np.ascontiguousarray(ip, dtype=np.float64)
        if infeasible:
            res = np.zeros(self.objective_count, dtype=np.int64)
        else:
            res = np.ascontiguousarray(result, dtype=np.int64)
        self._lib.moip_store_insert(
            self._h,
            ip.ctypes.data_as(_c_double_p),
            res.ctypes.data_as(_c_int64_p),
            1 if infeasible else 0,
        )

    @counted("store.find")
    def find(self, ip, sense: Sense):
        from moip_aira_tpu_torch.core.store import Result

        q = np.ascontiguousarray(ip, dtype=np.float64)
        out = np.zeros(self.objective_count, dtype=np.int64)
        inf_flag = ctypes.c_int(0)
        idx = self._lib.moip_store_find(
            self._h,
            q.ctypes.data_as(_c_double_p),
            1 if sense is Sense.MIN else 0,
            out.ctypes.data_as(_c_int64_p),
            ctypes.byref(inf_flag),
        )
        if idx < 0:
            return None
        if inf_flag.value:
            return Result(q, None, True)
        return Result(q, out, False)

    def find_batch(self, queries: np.ndarray, sense: Sense):
        B = queries.shape[0]
        k = self.objective_count
        qs = np.ascontiguousarray(queries, dtype=np.float64)
        hit = np.zeros(B, dtype=np.uint8)
        infeas = np.zeros(B, dtype=np.uint8)
        res = np.zeros((B, k), dtype=np.int64)
        if B:
            self._lib.moip_store_find_batch(
                self._h,
                qs.ctypes.data_as(_c_double_p),
                B,
                1 if sense is Sense.MIN else 0,
                hit.ctypes.data_as(_c_uint8_p),
                infeas.ctypes.data_as(_c_uint8_p),
                res.ctypes.data_as(_c_int64_p),
            )
        return hit.astype(bool), infeas.astype(bool), res

    @counted("store.merge")
    def merge(self, other: "NativeSolutions") -> None:
        self._lib.moip_store_merge(self._h, other._h)

    def sorted_unique_points(self) -> np.ndarray:
        n = len(self)
        k = self.objective_count
        out = np.zeros((max(n, 1), k), dtype=np.int64)
        cnt = self._lib.moip_store_sorted_unique(
            self._h, out.ctypes.data_as(_c_int64_p), n
        )
        return out[:cnt]

    def feasible_points(self) -> np.ndarray:
        # sorted_unique is a superset of what callers need here
        return self.sorted_unique_points()


def make_solutions(objective_count: int, prefer_native: bool = True):
    """Factory: native store when built, NumPy store otherwise."""
    if prefer_native and load_native() is not None:
        return NativeSolutions(objective_count)
    from moip_aira_tpu_torch.core.store import Solutions

    return Solutions(objective_count)

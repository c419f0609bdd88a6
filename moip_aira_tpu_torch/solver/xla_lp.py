"""The wave's XLA engine: batches of LPs on the dense simplex of
solver/simplex_dense.py, behind the interface of K1's and K2's wrappers.

The port of the reference wave's ``engine="xla"``
(``moip_aira_tpu/solver/wave.py:317-352``): ``simplex_jax.make_lp_solver``
vmapped and jitted over the unscaled system ``[A; C | -I]``.  In float32 it
runs with loose tolerances (every lane is then certified in float64 by the
wave), in float64 with ``simplex_jax``'s defaults; in both the sums follow
XLA's CPU order (``simplex_dense.xla_sum``), so its pivots follow the
reference's.  On a CUDA device each call is one launch of K5
(csrc/simplex_dense.cu), which pivots as the CPU does; ``launches`` counts
them (``LAUNCHES["simplex_dense"]``), and ``kernel`` stays ``"xla"``, the
engine's name.  K5 and the plain loop take any number of lanes, so a
call runs its lanes as they come.
"""

from __future__ import annotations

import time

import torch

from moip_aira_tpu_torch.solver.simplex_dense import DenseLPSolver
from moip_aira_tpu_torch.solver.simplex_torch import LPOutcome

#: the reference's float32 tolerances (moip_aira_tpu/solver/wave.py:324-327),
#: sized to the accumulation noise of float32 sums over the data; what they
#: get wrong the float64 certificates catch
F32_TOLERANCES = dict(feas_tol=1e-2, cost_tol=1e-2, pivot_tol=1e-3, progress_tol=1e-3)
DTYPES = {"float32": torch.float32, "float64": torch.float64}


class XlaLPBatch:
    """``__call__(c, lo, hi, wb, wa) -> LPOutcome`` over the system matrix
    ``W_np`` = [A | -I] (m, n + m), on ``device`` in ``dtype``.

    ``wb``/``wa`` (warm bases) are accepted and ignored, as the reference's
    ``_run_xla`` ignores them.  ``steps``, ``syncs`` and ``launches`` count
    the solver's loop steps, its host reads of the device and K5's
    launches; ``seconds`` is the host's time inside the calls, each of
    which waits for its results; ``plan_launches`` counts K5's launches by
    their plan's (shape, C, P)."""

    kernel = "xla"

    def __init__(self, W_np, device, max_iters: int = 2000, dtype: str = "float32"):
        if dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {tuple(DTYPES)}, got {dtype!r}")
        self.dtype = DTYPES[dtype]
        self.W = torch.as_tensor(W_np, dtype=self.dtype).to(torch.device(device))
        self.device = self.W.device
        self.m, nc = self.W.shape
        self.n = nc - self.m
        self.max_iters = int(max_iters)
        tol = F32_TOLERANCES if self.dtype == torch.float32 else {}
        self.solver = DenseLPSolver(self.W, self.max_iters, **tol)
        self.seconds = 0.0

    @property
    def launches(self) -> int:
        return self.solver.launches

    @property
    def steps(self) -> int:
        return self.solver.steps

    @property
    def plan_launches(self):
        return self.solver.plan_launches

    @property
    def syncs(self) -> int:
        return self.solver.syncs

    def __call__(self, c, lo, hi, wb=None, wa=None) -> LPOutcome:
        t0 = time.perf_counter()
        B = c.shape[0]
        nc = self.n + self.m
        for name, t in (("c", c), ("lo", lo), ("hi", hi)):
            if t.device != self.device:
                raise ValueError(f"{name} lies on {t.device}, the solver on {self.device}")
            if t.dtype != self.dtype:
                raise TypeError(f"{name} must be {self.dtype}, got {t.dtype}")
            if tuple(t.shape) != (B, nc):
                raise ValueError(f"{name} must have shape {(B, nc)}, got {tuple(t.shape)}")
        out = self.solver(c, lo, hi)
        self.seconds += time.perf_counter() - t0
        return out._replace(
            basis=out.basis.to(torch.int32), at_upper=out.at_upper.to(torch.int32)
        )

"""The wave's XLA engine: batches of LPs on the dense simplex of
solver/simplex_dense.py, behind the interface of K1's and K2's wrappers.

The port of the reference wave's ``engine="xla"``
(``moip_aira_tpu/solver/wave.py:317-352``): ``simplex_jax.make_lp_solver``
vmapped and jitted over the unscaled system ``[A; C | -I]``.  In float32 it
runs with loose tolerances (every lane is then certified in float64 by the
wave) and its sums in the order XLA's CPU backend computes them
(``simplex_dense.xla_sum``), so its pivots follow the reference's; in
float64 with ``simplex_jax``'s defaults.  No hand-written kernel runs here:
``launches`` stays 0 and ``kernel`` is ``"xla"``.

On a CUDA device the solver's start and step are CUDA graphs, one pair per
batch size; the lanes of a call are padded up to the next power of two (at
most ``max_lanes``) with the reference's trivial LP, c = lo = hi = 0, which
is OPTIMAL at its first step, and the padding's outputs are dropped.
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


def bucket(lanes: int, max_lanes: int) -> int:
    """The batch a call of ``lanes`` lanes runs as: the next power of two,
    at most ``max(lanes, max_lanes)``."""
    return min(1 << max(lanes - 1, 0).bit_length(), max(lanes, max_lanes))


class XlaLPBatch:
    """``__call__(c, lo, hi, wb, wa) -> LPOutcome`` over the system matrix
    ``W_np`` = [A | -I] (m, n + m), on ``device`` in ``dtype``.

    ``wb``/``wa`` (warm bases) are accepted and ignored, as the reference's
    ``_run_xla`` ignores them.  ``steps``, ``syncs`` and ``graphs`` count the
    solver's loop steps, its host reads of the loop condition and the CUDA
    graphs it captured (one start and one step graph a batch size);
    ``seconds`` is the host's time inside the calls, which wait for the
    device at every step."""

    kernel = "xla"

    def __init__(self, W_np, device, max_iters: int = 2000, dtype: str = "float32",
                 max_lanes: int = 256):
        if dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {tuple(DTYPES)}, got {dtype!r}")
        self.dtype = DTYPES[dtype]
        self.W = torch.as_tensor(W_np, dtype=self.dtype).to(torch.device(device))
        self.device = self.W.device
        self.m, nc = self.W.shape
        self.n = nc - self.m
        self.max_iters = int(max_iters)
        self.max_lanes = int(max_lanes)
        tol = F32_TOLERANCES if self.dtype == torch.float32 else {}
        self.solver = DenseLPSolver(self.W, self.max_iters, **tol)
        self.launches = 0  # no hand-written kernel runs on this engine
        #: pad each call to its bucket: on a card, where each batch size
        #: captures graphs of its own
        self.bucketed = self.device.type == "cuda"
        self.seconds = 0.0

    @property
    def steps(self) -> int:
        return self.solver.steps

    @property
    def syncs(self) -> int:
        return self.solver.syncs

    @property
    def graphs(self) -> int:
        return 2 * len(self.solver._graphs)

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
        if self.bucketed:
            P = bucket(B, self.max_lanes)
            if P > B:
                pad = (0, 0, 0, P - B)  # the trivial LP: c = lo = hi = 0
                c, lo, hi = (torch.nn.functional.pad(t, pad) for t in (c, lo, hi))
        out = self.solver(c, lo, hi)
        self.seconds += time.perf_counter() - t0
        return LPOutcome(
            status=out.status[:B],
            obj=out.obj[:B],
            x=out.x[:B],
            basis=out.basis[:B].to(torch.int32),
            at_upper=out.at_upper[:B].to(torch.int32),
            iters=out.iters[:B],
        )

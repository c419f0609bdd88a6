"""Full-front dynamic program for bi-objective knapsack instances — the port
of ``moip_aira_tpu/solver/kp_front.py``.

For the *single-capacity* bi-objective knapsack family the whole
nondominated set is one dense dynamic program

    g[c, s] = max { v0(T) : T subset of items, w(T) <= c, v1(T) == s }

over a (cap + 1, S + 1) int32 table, S the sum of the smaller value row.
Each item updates every cell once,

    g[c, s] = max(g[c, s], g[c - w, s - a] + b  if g[c - w, s - a] >= 0 else -1),

with -1 marking an unreachable (c, s); the front is read off the row
c = cap.  No branching, no LP and no tolerances: the arithmetic is exact
integer throughout, so the result needs no certification.

Detection (``detect_kp2``), the numpy oracle (``front_np``) and the front
extraction are the reference's code.  The device DP has two versions:

* ``front_cuda``: kernel K4 (``csrc/kp_dp.cu``, wrapper
  ``solver/cuda_dp.py``), one launch per item, ping-pong between two
  tables; only the answer row comes back to the host;
* ``front_torch``: its plain PyTorch version (``dp_table_ref``), the same
  update in place, one item at a time, on int32 tensors of any device.

``kp2_front`` detects and solves; on a CUDA device it runs K4 or raises,
and nothing falls back to the plain version or to the numpy oracle.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from moip_aira_tpu_torch.device import resolve_device
from moip_aira_tpu_torch.problem import Problem
from moip_aira_tpu_torch.sense import Sense

#: hard ceiling on table cells (int32) so detection never commits the
#: device path to an allocation it cannot make: 2^31 cells = 8 GB (K4's
#: two tables take 16 GB of the card's 80)
MAX_TABLE_CELLS = 2**31
#: numpy-oracle ceiling — the python loop over items is ~1 GB/s, keep the
#: oracle to sizes where it answers in seconds.
MAX_TABLE_CELLS_NP = 2**27


@dataclasses.dataclass
class KP2:
    """Canonical maximisation form: max (V[0]·x, V[1]·x) s.t. w·x <= cap,
    x binary after multiplicity expansion."""

    w: np.ndarray  # (n_items,) int64 > 0 expanded weights
    V: np.ndarray  # (2, n_items) int64 >= 0 expanded values
    cap: int
    #: True when the original problem minimises (points are negated back)
    negate: bool
    #: which original objective rides the DP s-axis (the smaller value sum)
    s_axis: int

    @property
    def table_cells(self) -> int:
        return (self.cap + 1) * (int(self.V[1].sum()) + 1)


def detect_kp2(problem: Problem) -> Optional[KP2]:
    """Return the canonical KP2 structure, or None if it doesn't apply.

    Accepts: 2 objectives; all variables integer with lb 0; exactly one
    structural row that is a pure <= capacity row (or >= with nonpositive
    data, the mirrored form); objective/weight data integral; objectives
    uniformly "profit-like" (maximise nonnegative, or minimise nonpositive
    as the reference's .mop convention encodes it).
    """
    p = problem
    if p.objcnt != 2 or p.m_struct != 1:
        return None
    if not bool(np.all(p.is_int)):
        return None
    if not bool(np.all(p.lb == 0)):
        return None
    w = np.asarray(p.A[0], dtype=np.float64)
    row_lb = float(p.row_lb[0])
    row_ub = float(p.row_ub[0])
    if np.isfinite(row_ub) and not np.isfinite(row_lb):
        cap = row_ub
    elif np.isfinite(row_lb) and not np.isfinite(row_ub) and np.all(w <= 0):
        # -w·x >= -cap mirrored form
        w, cap = -w, -row_lb
    else:
        return None
    if cap < 0 or np.any(w < 0):
        return None
    if not np.all(w == np.rint(w)):
        return None
    # integer weights make a fractional capacity equivalent to its floor
    cap = math.floor(cap)
    C = np.asarray(p.C, dtype=np.float64)
    if not np.all(C == np.rint(C)):
        return None
    if p.objsen is Sense.MAX and np.all(C >= 0):
        V = C.copy()
        negate = False
    elif p.objsen is Sense.MIN and np.all(C <= 0):
        V = -C
        negate = True
    else:
        return None

    # effective integer upper bounds; unbounded vars are capped by capacity
    ub = np.asarray(p.ub, dtype=np.float64).copy()
    unb = ~np.isfinite(ub)
    if np.any(unb):
        with np.errstate(divide="ignore"):
            by_cap = np.floor(np.where(w > 0, cap / np.maximum(w, 1e-300), 0))
        # a zero-weight unbounded var with positive value => unbounded front
        if np.any(unb & (w == 0) & (V.max(axis=0) > 0)):
            return None
        ub[unb] = by_cap[unb]
    ub = np.rint(ub).astype(np.int64)
    w = np.rint(w).astype(np.int64)
    V = np.rint(V).astype(np.int64)
    cap = int(cap)

    # drop useless items; expand multiplicities by binary splitting
    ws, v0s, v1s = [], [], []
    for i in range(p.n):
        u = int(ub[i])
        if u <= 0 or (V[0, i] == 0 and V[1, i] == 0):
            continue
        if w[i] > cap:
            continue
        u = min(u, cap // w[i]) if w[i] > 0 else u
        t = 1
        while u > 0:
            k = min(t, u)
            ws.append(w[i] * k)
            v0s.append(V[0, i] * k)
            v1s.append(V[1, i] * k)
            u -= k
            t *= 2
    if not ws:
        w_e = np.zeros(0, dtype=np.int64)
        V_e = np.zeros((2, 0), dtype=np.int64)
    else:
        w_e = np.asarray(ws, dtype=np.int64)
        V_e = np.stack(
            [np.asarray(v0s, dtype=np.int64), np.asarray(v1s, dtype=np.int64)]
        )

    # the smaller value sum rides the s-axis (smaller table)
    s_axis = int(np.argmin(V_e.sum(axis=1))) if w_e.size else 1
    if s_axis == 0:
        V_e = V_e[::-1].copy()
    kp = KP2(w=w_e, V=V_e, cap=int(cap), negate=negate, s_axis=s_axis)
    if kp.table_cells > MAX_TABLE_CELLS:
        return None
    return kp


def _extract_front(last_row: np.ndarray, kp: KP2) -> np.ndarray:
    """Nondominated (obj0, obj1) points from the c=cap table row, in the
    problem's native objective order and the store's descending-lex sort."""
    best = np.asarray(last_row, dtype=np.int64)
    S = best.shape[0] - 1
    pts = []
    run = -1
    for s in range(S, -1, -1):
        if best[s] > run:
            run = int(best[s])
            pts.append((run, s))
    if not pts:
        return np.zeros((0, 2), dtype=np.int64)
    arr = np.asarray(pts, dtype=np.int64)  # columns: (v_other, v_s)
    if kp.s_axis == 0:
        arr = arr[:, ::-1]
    if kp.negate:
        arr = -arr
    order = np.lexsort((arr[:, 1], arr[:, 0]))
    return arr[order[::-1]]


def front_np(kp: KP2) -> np.ndarray:
    """NumPy oracle: full-table DP, exact int32 arithmetic."""
    S = int(kp.V[1].sum())
    C = kp.cap
    if (C + 1) * (S + 1) > MAX_TABLE_CELLS_NP:
        raise MemoryError(
            f"KP2 table {(C + 1)}x{(S + 1)} exceeds the numpy-oracle budget"
        )
    g = np.full((C + 1, S + 1), -1, dtype=np.int32)
    g[:, 0] = 0
    for wi, b0, a1 in zip(kp.w, kp.V[0], kp.V[1]):
        wi, b0, a1 = int(wi), int(b0), int(a1)
        src = g[: C + 1 - wi, : S + 1 - a1]
        cand = np.where(src >= 0, src + b0, -1)
        tgt = g[wi:, a1:]
        np.maximum(tgt, cand, out=tgt)
    return _extract_front(g[C], kp)


def value_sum(kp: KP2) -> int:
    """S, the last column of the table: the sum of the s-axis values."""
    return int(kp.V[1].sum())


def dp_items(kp: KP2, device) -> torch.Tensor:
    """The expanded items as the (3, n) int32 tensor K4 and its plain
    version take: rows w, b (the value on the table), a (the s-axis value)."""
    items = np.stack([kp.w, kp.V[0], kp.V[1]]).astype(np.int32).reshape(3, -1)
    return torch.as_tensor(items, device=device).contiguous()


def dp_table_ref(items: torch.Tensor, cap: int, S: int) -> torch.Tensor:
    """The plain version of K4: the final (cap + 1, S + 1) int32 table on
    the items' device, every item applied in place in order, as
    ``front_np`` does.  The candidate of an item is computed whole from the
    table before the item's maximum writes it back, so every cell reads
    the previous item's values, as K4's ping-pong does."""
    g = torch.full((cap + 1, S + 1), -1, dtype=torch.int32, device=items.device)
    g[:, 0] = 0
    for w, b, a in items.t().tolist():
        if w > cap or a > S:
            continue
        src = g[: cap + 1 - w, : S + 1 - a]
        cand = torch.where(src >= 0, src + b, -1)
        tgt = g[w:, a:]
        torch.maximum(tgt, cand, out=tgt)
    return g


def front_torch(kp: KP2, device="cpu") -> np.ndarray:
    """The front from the plain version of K4 on ``device``."""
    dev = resolve_device(device)
    g = dp_table_ref(dp_items(kp, dev), kp.cap, value_sum(kp))
    return _extract_front(g[kp.cap].cpu().numpy(), kp)


def front_cuda(kp: KP2, device="cuda", dp=None) -> np.ndarray:
    """The front from K4 on the CUDA ``device``: one launch per item, and
    only the answer row g[cap, 0:S+1] copied to the host.  ``dp`` is the
    wrapper to launch through (a new ``CudaKPDP`` when None); its
    ``launches`` counts the launches."""
    from moip_aira_tpu_torch.solver.cuda_dp import CudaKPDP

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"front_cuda runs K4 on a CUDA device, not {dev}")
    dp = CudaKPDP() if dp is None else dp
    g = dp(dp_items(kp, dev), kp.cap, value_sum(kp))
    return _extract_front(g[kp.cap].cpu().numpy(), kp)


ENGINES = ("auto", "numpy", "torch", "cuda")


def kp2_front(
    problem: Problem, engine: str = "auto", device="cuda", stats: Optional[dict] = None
) -> Optional[np.ndarray]:
    """Detect + solve; returns sorted nondominated points or None.

    ``engine``: 'auto' (K4 on a CUDA device, the plain version on the
    CPU), 'cuda' (K4), 'torch' (the plain version on ``device``), 'numpy'
    (the oracle).  The device is resolved only for a detected KP2, so a
    problem of another family never touches it.  ``stats``, when given, is
    filled with what ran: backend, kernel, its launches, the expanded
    items, the table cells and the engine."""
    if engine not in ENGINES:
        raise ValueError(f"unknown kp_front engine {engine!r}")
    kp = detect_kp2(problem)
    if kp is None:
        return None
    dp = None
    if engine == "numpy":
        pts = front_np(kp)
    else:
        dev = resolve_device(device)
        if engine == "auto":
            engine = "cuda" if dev.type == "cuda" else "torch"
        if engine == "cuda":
            from moip_aira_tpu_torch.solver.cuda_dp import CudaKPDP

            dp = CudaKPDP()
            pts = front_cuda(kp, dev, dp)
        else:
            pts = front_torch(kp, dev)
    if stats is not None:
        stats.update(
            backend="kp_front",
            kernel="kp_dp",
            kernel_launches=dp.launches if dp is not None else 0,
            items=int(kp.w.shape[0]),
            table_cells=kp.table_cells,
            engine=engine,
        )
    return pts

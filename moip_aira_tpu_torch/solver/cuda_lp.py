"""The batched LP kernels on the card, and their wrappers.

* K1, the dense-tableau simplex (counterpart of
  ``moip_aira_tpu/solver/pallas_lp.py``): kernel ``csrc/dense_simplex.cu``,
  plain version ``simplex_torch.dense_lp_batch_ref``, wrapper
  ``make_cuda_lp_batch``;
* K2, the revised simplex (counterpart of
  ``moip_aira_tpu/solver/pallas_rev.py``): kernel
  ``csrc/revised_simplex.cu``, plain version
  ``simplex_torch.revised_lp_batch_ref``, wrapper ``make_cuda_rev_batch``.

K1 runs each LP lane on a warp, a block or a cluster of C blocks, the shape
chosen per launch by ``dense_launch_plan``; K2 one cluster of C blocks per
lane, C and the shared-memory layout chosen per launch by
``rev_launch_plan``.
Each wrapper returns a
callable with the unpacked contract of the Pallas builders
(``pack=False``): ``(c, lo, hi, wb, wa) -> LPOutcome(status, obj, x, basis,
at_upper, iters)``.

The callable works by the device of the tensors it is given: on CUDA tensors
it launches its kernel, on CPU tensors it runs the plain version.  It never
does both, and nothing lets a failed launch continue on the other."""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from dataclasses import dataclass

import torch

from moip_aira_tpu_torch.kernels.build import load
from moip_aira_tpu_torch.solver.simplex_torch import (
    LPOutcome,
    dense_lp_batch_ref,
    revised_lp_batch_ref,
)


#: launches of each kernel in this process, by kernel name (the wrappers'
#: own ``launches`` count per object; K3's wrapper is solver/cuda_bb.py,
#: K4's solver/cuda_dp.py, K5's solver/cuda_dense.py, K6's
#: solver/cuda_lex.py); ``reset_launches`` zeroes them
LAUNCHES = {
    "dense_simplex": 0, "revised_simplex": 0, "bb_fragment": 0, "kp_dp": 0,
    "simplex_dense": 0, "lex_bnb": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _dense_simplex_lib() -> ctypes.CDLL:
    return _bind_dense(load("dense_simplex"))


def _bind_dense(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    pi = ctypes.POINTER(ci)
    lib.dense_simplex_device_limits.argtypes = [pi, pi]
    lib.dense_simplex_device_limits.restype = ci
    lib.dense_simplex_smem_bytes.argtypes = [ci] * 5
    lib.dense_simplex_smem_bytes.restype = ctypes.c_longlong
    lib.dense_simplex_max_clusters.argtypes = [ci] * 6
    lib.dense_simplex_max_clusters.restype = ci
    lib.dense_simplex_launch.argtypes = [
        vp, ci, ci, ci,  # W, m, n, batch
        vp, vp, vp, vp, vp,  # c, lo, hi, wb, wa
        ci, cf, cf, cf,  # max_iters, feas_tol, cost_tol, pivot_tol
        ci, ci, ci, ci,  # the plan: shape, C, threads, P
        vp, vp, vp, vp, vp, vp,  # status, obj, x, basis, at_upper, iters
        vp,  # stream
    ]
    lib.dense_simplex_launch.restype = ci
    return lib


@functools.lru_cache(maxsize=None)
def _dense_simplex_variant(defines: tuple) -> ctypes.CDLL:
    """K1's library built with extra ``-D`` flags (an instrumented variant
    of tools/k1_bench.py beside the production one)."""
    return _bind_dense(load("dense_simplex", defines))


@functools.lru_cache(maxsize=None)
def _revised_simplex_lib() -> ctypes.CDLL:
    lib = load("revised_simplex")
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    pi = ctypes.POINTER(ci)
    lib.revised_simplex_device_limits.argtypes = [pi, pi]
    lib.revised_simplex_device_limits.restype = ci
    lib.revised_simplex_smem_bytes.argtypes = [ci] * 6
    lib.revised_simplex_smem_bytes.restype = ctypes.c_longlong
    lib.revised_simplex_max_clusters.argtypes = [ci] * 7
    lib.revised_simplex_max_clusters.restype = ci
    lib.revised_simplex_launch.argtypes = [
        vp, ci, ci, ci,  # W, m, n, batch
        vp, vp, vp, vp, vp,  # c, lo, hi, wb, wa
        ci, cf, cf, cf,  # max_iters, feas_tol, cost_tol, pivot_tol
        ci, ci, ci, ci, ci,  # the plan: C, threads, W, B^-1, P1 in smem
        vp, vp, vp,  # B^-1, P1 and z scratch
        vp, vp, vp, vp, vp, vp,  # status, obj, x, basis, at_upper, iters
        vp,  # stream
    ]
    lib.revised_simplex_launch.restype = ci
    return lib


@functools.lru_cache(maxsize=None)
def _rev_max_clusters(device: int, m: int, n: int, C: int, threads: int,
                      w_smem: bool, bi_smem: bool, p1_smem: bool) -> int:
    with torch.cuda.device(device):
        got = _revised_simplex_lib().revised_simplex_max_clusters(
            m, n, C, threads, int(w_smem), int(bi_smem), int(p1_smem)
        )
    if got < 0:
        raise RuntimeError(f"K2: occupancy of C={C} for {m} x {n + m} failed: CUDA error {-got}")
    return got


# K2's limits, as csrc/revised_simplex.cu and csrc/simplex_common.cuh set
# them: threads a block, blocks a cluster (the portable cluster size), float
# vectors of m entries a lane, and the static shared bytes set aside beside
# the dynamic part
REV_MAX_THREADS = 512
REV_MAX_CLUSTER = 8
REV_ROW_VECTORS = 9
STATIC_SMEM_RESERVE = 1024
#: the fewest columns a block of a split lane prices: four warps' worth, so
#: that a block is not left mostly idle in pricing (a bound, not measured)
REV_MIN_SLICE = 128


def rev_smem_bytes(m: int, nc: int, C: int, w_smem: bool, bi_smem: bool,
                   p1_smem: bool) -> int:
    """A K2 block's dynamic shared bytes: the per-row and per-column vectors
    (16-byte aligned), plus B^-1 and P1 (m x m floats each) and the block's
    slice of W (m x ceil(nc / C) floats) where the plan keeps them there
    (``rev_smem_bytes`` of csrc/revised_simplex.cu)."""
    vec = 4 * REV_ROW_VECTORS * m + 4 * 2 * m + 2 * nc + 2 * m
    vec = (vec + 15) & ~15
    square = 4 * m * m
    width = -(-nc // C)
    return (vec + (square if bi_smem else 0) + (square if p1_smem else 0)
            + (4 * m * width if w_smem else 0))


@dataclass(frozen=True)
class RevPlan:
    """One K2 launch: C blocks of ``threads`` threads per lane, and which of
    the block's W slice, B^-1 and warm block P1 sit in shared memory."""

    m: int
    nc: int
    C: int
    threads: int
    w_smem: bool
    bi_smem: bool
    p1_smem: bool

    @property
    def width(self) -> int:
        """Columns a block owns: block r prices [r * width, r * width +
        width), cut at nc."""
        return -(-self.nc // self.C)

    @property
    def slices(self) -> tuple:
        w = self.width
        return tuple((min(self.nc, r * w), min(self.nc, r * w + w)) for r in range(self.C))

    @property
    def smem_bytes(self) -> int:
        return rev_smem_bytes(self.m, self.nc, self.C, self.w_smem, self.bi_smem, self.p1_smem)

    @property
    def layout(self) -> str:
        """What shared memory holds, e.g. "B^-1+W+P1"; "-" for nothing."""
        parts = [n for n, on in (("B^-1", self.bi_smem), ("W", self.w_smem), ("P1", self.p1_smem)) if on]
        return "+".join(parts) or "-"


def cluster_sizes_for(nc: int) -> list:
    """The cluster sizes a lane of ``nc`` columns may take: powers of two up
    to REV_MAX_CLUSTER that leave each block at least REV_MIN_SLICE columns
    (always 1)."""
    return [C for C in (1, 2, 4, 8) if C == 1 or -(-nc // C) >= REV_MIN_SLICE]


def pick_cluster(sizes, fits, lanes: int, sms: int, held) -> int:
    """The cluster size of a launch of ``lanes`` lanes: the smallest C of
    ``fits`` (the sizes whose W slice sits in shared memory) while the card
    holds a cluster of C for every lane at once, else the largest C it
    still holds them all at (1 when it holds them at none).  ``held`` maps C
    to the clusters of C blocks the card holds at once
    (cudaOccupancyMaxActiveClusters); no more than ``sms // C`` count."""

    def room(C):
        return lanes <= min(held.get(C, 0), sms // C)

    if fits and room(fits[0]):
        return fits[0]
    return max(C for C in sizes if C == 1 or room(C))


def rev_launch_plan(m: int, n: int, lanes: int, smem_bytes: int, sms: int, held) -> RevPlan:
    """K2's launch for ``lanes`` LPs of m rows and n structural columns on a
    card of ``sms`` SMs whose blocks may opt into ``smem_bytes`` of shared
    memory and which holds ``held[C]`` clusters of C blocks at once.

    C, the blocks of a lane's cluster, is one of ``cluster_sizes_for``.
    Within those: the smallest C whose W slice fits in shared memory beside
    B^-1, while the card holds a cluster for every lane at once (pricing
    from shared memory makes more blocks worth little more than their
    cluster barrier); else the largest C at which it still holds them all
    (pricing then streams W from L2, and each block adds an SM's share of
    it); lanes past what the card holds would wait for a second round of
    clusters (pick_cluster).  Measured on the H100
    (tools/k2_cluster_bench.py --sweep; PERF.md §6), this picks the
    fastest C or one within 6% of it: 2AP40 takes 4 for 1 and 8 lanes, 2
    for 64 and 1 for 256; 2AP100 8 for 1 and 8 lanes, 2 for 64 and 1 for
    256.  Shared memory takes B^-1 first (every pivot reads it three
    times), then the block's W slice (pricing reads it once), then the warm
    block P1 (one rebuild a launch); what does not fit stays in global
    memory.  Raises ValueError when not even the per-row and per-column
    vectors fit."""
    nc = n + m
    sizes = cluster_sizes_for(nc)
    fits = [C for C in sizes if rev_plan_for(m, n, C, smem_bytes).w_smem]
    return rev_plan_for(m, n, pick_cluster(sizes, fits, max(lanes, 1), sms, held), smem_bytes)


def rev_plan_for(m: int, n: int, C: int, smem_bytes: int) -> RevPlan:
    """K2's launch with clusters of C blocks: the shared-memory layout and
    the block size of ``rev_launch_plan`` for that C."""
    nc = n + m
    cap = smem_bytes - STATIC_SMEM_RESERVE
    if rev_smem_bytes(m, nc, 1, False, False, False) > cap:
        raise ValueError(f"K2 cannot take an LP of {m} rows and {nc} columns")
    bi = rev_smem_bytes(m, nc, C, False, True, False) <= cap
    w = bi and rev_smem_bytes(m, nc, C, True, True, False) <= cap
    p1 = bi and rev_smem_bytes(m, nc, C, w, True, True) <= cap
    width = -(-nc // C)
    # a thread per column of the slice, the warps rev_pivot_start needs to
    # run both y's (m threads each, from a warp boundary) and its two
    # serial sums side by side, and at most eight elements of B^-1 a thread
    # in the rank-1 update
    want = max(width, 2 * 32 * -(-m // 32) + 64, -(-m * m // 8))
    return RevPlan(m, nc, C, min(REV_MAX_THREADS, 32 * -(-want // 32)), w, bi, p1)


# K1's limits, as csrc/dense_simplex.cu sets them: threads a block of the
# block and cluster shapes, blocks a cluster, and the packed shape's rows,
# columns and lanes a block
DENSE_MAX_THREADS = 256
DENSE_MAX_CLUSTER = 8
DENSE_PACK_ROWS = 32
DENSE_PACK_COLS = 128
DENSE_MAX_PACK = 8
#: lanes (warps) a block of the packed shape
DENSE_PACK_LANES = 4
#: the fewest columns a block of a split K1 lane owns: two warps' worth of
#: columns, so that pricing and the rank-1 update keep at least two warps a
#: block busy; 2AP20 on 8 blocks of 56 columns ran slower than on 4 of 111
#: (918 against 835 device µs for one lane, tools/k1_bench.py --sweep)
DENSE_MIN_SLICE = 64
#: K1's execution shapes, by their code in csrc/dense_simplex.cu
DENSE_SHAPES = ("packed", "block", "cluster")


def dense_smem_bytes(shape: str, m: int, nc: int, C: int = 1, P: int = 1) -> int:
    """A K1 block's dynamic shared bytes (``dense_smem_bytes`` of
    csrc/dense_simplex.cu).  Packed: P lanes of the tableau (m x nc), c, lo,
    hi, z (nc each) and three m-vectors as f32, and two nc-byte flag
    arrays, each lane 16-byte aligned.  Block and cluster: the block's
    tableau slice (m x ceil(nc / C) f32), c, lo, hi, z, nine m-vectors and
    the published entering columns (2 C m) as f32, two m-vectors (i32) and
    the two flag arrays, 16-byte aligned."""
    if shape == "packed":
        lane = 4 * (m * nc + 4 * nc + 3 * m) + 2 * nc
        return P * ((lane + 15) & ~15)
    w = -(-nc // C)
    b = 4 * (m * w + 4 * nc + 9 * m + 2 * C * m) + 4 * 2 * m + 2 * nc
    return (b + 15) & ~15


@dataclass(frozen=True)
class DensePlan:
    """One K1 launch: the execution shape ("packed": P lanes a block, one
    warp each; "block": one block of ``threads`` a lane; "cluster": C such
    blocks a lane, block r owning the tableau's columns [r * width, r *
    width + width)).  Every shape keeps the lane's tableau in shared
    memory."""

    m: int
    nc: int
    shape: str
    C: int
    threads: int
    P: int = 1

    @property
    def code(self) -> int:
        return DENSE_SHAPES.index(self.shape)

    @property
    def width(self) -> int:
        """Columns of the tableau a block keeps: nc but on a cluster."""
        return -(-self.nc // self.C)

    @property
    def slices(self) -> tuple:
        w = self.width
        return tuple((min(self.nc, r * w), min(self.nc, r * w + w)) for r in range(self.C))

    @property
    def smem_bytes(self) -> int:
        return dense_smem_bytes(self.shape, self.m, self.nc, self.C, self.P)

    @property
    def layout(self) -> str:
        """What a block's shared memory holds: "T" (the lane's tableau),
        "T/C" (its slice on a cluster of C), "P x T" (P lanes' tableaux)."""
        if self.shape == "packed":
            return f"{self.P} x T"
        return "T" if self.C == 1 else f"T/{self.C}"

    def blocks(self, lanes: int) -> int:
        return -(-lanes // self.P) if self.shape == "packed" else lanes * self.C


def dense_packs(m: int, nc: int) -> bool:
    """Whether a warp can run the lane: a row for each of its 32 threads and
    at most four columns each."""
    return m <= DENSE_PACK_ROWS and nc <= DENSE_PACK_COLS


def dense_cluster_sizes(nc: int) -> list:
    """The clusters a K1 lane of ``nc`` columns may take: 2, 4 and 8 blocks,
    each keeping at least DENSE_MIN_SLICE columns."""
    return [C for C in (2, 4, 8) if -(-nc // C) >= DENSE_MIN_SLICE]


def dense_plan_for(m: int, n: int, shape: str, C: int, smem_bytes: int,
                   P: int = DENSE_PACK_LANES) -> DensePlan:
    """K1's launch of the given shape (and C for "cluster", P lanes a block
    for "packed") on a card whose blocks may opt into ``smem_bytes`` of
    shared memory: each thread prices and updates ceil(width /
    DENSE_MAX_THREADS) of the block's columns, as few threads as spread
    them evenly (2AP20's 442 columns on a block: 224 threads of two), at
    least two warps.  Raises ValueError when the shape cannot take the LP
    or its shared memory does not fit."""
    nc = n + m
    cap = smem_bytes - STATIC_SMEM_RESERVE
    if shape == "packed":
        if not dense_packs(m, nc) or not 1 <= P <= DENSE_MAX_PACK or C != 1:
            raise ValueError(f"K1 packs no LP of {m} rows and {nc} columns, {P} a block")
        plan = DensePlan(m, nc, shape, 1, 32 * P, P)
    elif shape in ("block", "cluster"):
        if (shape == "block") != (C == 1) or not 1 <= C <= DENSE_MAX_CLUSTER:
            raise ValueError(f"K1's {shape} shape takes no cluster of {C}")
        width = -(-nc // C)
        per = -(-width // DENSE_MAX_THREADS)  # columns a thread
        threads = max(64, 32 * -(-width // (32 * per)))
        plan = DensePlan(m, nc, shape, C, threads)
    else:
        raise ValueError(f"K1 has no shape {shape!r}")
    if plan.smem_bytes > cap:
        raise ValueError(
            f"K1's {plan.layout} for {m} rows and {nc} columns needs "
            f"{plan.smem_bytes} shared bytes, the card gives {cap}"
        )
    return plan


def dense_launch_plan(m: int, n: int, lanes: int, smem_bytes: int, sms: int, held) -> DensePlan:
    """K1's launch for ``lanes`` LPs of m rows and n structural columns on a
    card of ``sms`` SMs whose blocks may opt into ``smem_bytes`` of shared
    memory and which holds ``held[C]`` clusters of C blocks of K1's cluster
    plan at once.

    * ``packed`` (a warp a lane) whenever a warp can run the lane
      (``dense_packs``: G3KP10, KP2D50, G2AP05, G3AP05);
    * else, when one block holds the tableau, ``cluster`` at the largest C
      of ``dense_cluster_sizes`` whose slice fits and of which the card
      holds a cluster for every lane at once (``held[C]``; small slices
      put several blocks on an SM), else ``block``.  A lane's pivot is a
      chain of latencies, and a long launch ends with one lane alone on its
      SMs, where four blocks are fastest (tools/k1_bench.py --sweep on the
      H100: one 2AP20 lane 835 µs on 4 blocks, 903 on 2, 1,107 on one; 32
      lanes 934, 984, 1,203; PERF.md §6);
    * else (2AP40's 552 KB tableau) ``cluster`` at the largest C whose
      slice fits and at which the card holds every lane (``pick_cluster``
      with no C preferred); when it holds them at none, the C of the
      fewest rounds of clusters, the larger C
      among equals (2AP40's 256 lanes: 30 clusters of four and 30 of eight
      on the H100, so eight: 45.8 against 59.9 ms of device time by
      tools/k1_bench.py --sweep).

    Raises ValueError when no shape fits."""
    nc = n + m
    lanes = max(lanes, 1)
    cap = smem_bytes - STATIC_SMEM_RESERVE
    if dense_packs(m, nc) and dense_smem_bytes("packed", m, nc, 1, DENSE_PACK_LANES) <= cap:
        return dense_plan_for(m, n, "packed", 1, smem_bytes)
    fits = [C for C in dense_cluster_sizes(nc) if dense_smem_bytes("cluster", m, nc, C) <= cap]
    if dense_smem_bytes("block", m, nc) <= cap:
        C = max([1] + [C for C in fits if lanes <= held.get(C, 0)])
        if C > 1:
            return dense_plan_for(m, n, "cluster", C, smem_bytes)
        return dense_plan_for(m, n, "block", 1, smem_bytes)
    if not fits:
        raise ValueError(f"K1 cannot take an LP of {m} rows and {nc} columns")
    if any(lanes <= min(held.get(C, 0), sms // C) for C in fits):
        C = pick_cluster(fits, [], lanes, sms, held)
    else:
        C = min(fits, key=lambda C: (-(-lanes // max(1, held.get(C, 0))), -C))
    return dense_plan_for(m, n, "cluster", C, smem_bytes)


@functools.lru_cache(maxsize=None)
def _dense_max_clusters(device: int, plan: DensePlan) -> int:
    with torch.cuda.device(device):
        got = _dense_simplex_lib().dense_simplex_max_clusters(
            plan.code, plan.m, plan.nc - plan.m, plan.C, plan.threads, plan.P
        )
    if got < 0:
        raise RuntimeError(f"K1: occupancy of {plan} failed: CUDA error {-got}")
    return got


class _LPBatch:
    """What K1's and K2's wrappers share: the contract, the input checks,
    the outputs and the dispatch by device.  ``launches`` counts the kernel
    launches the object made."""

    #: the kernel's name: its csrc/ source, its key in LAUNCHES and the
    #: "kernel" of backend_stats
    kernel = ""
    plain = None

    def __init__(
        self,
        W_dev: torch.Tensor,
        device: torch.device,
        max_iters: int = 2000,
        feas_tol: float = 3e-4,
        cost_tol: float = 3e-5,
        pivot_tol: float = 3e-5,
    ):
        self.W = W_dev.to(device=torch.device(device), dtype=torch.float32).contiguous()
        #: W's device (a CPU named with an index is the CPU all the same)
        self.device = self.W.device
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

    def run(self, c, lo, hi, wb, wa, plan) -> LPOutcome:
        """Launch the kernel with the given plan instead of the chosen one
        (to measure plans against each other); CUDA tensors only."""
        self._check(c, lo, hi, wb, wa)
        if c.device.type != "cuda":
            raise ValueError("a launch plan needs CUDA tensors")
        return self._launch(c, lo, hi, wb, wa, plan)

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


class CudaLPBatch(_LPBatch):
    """K1: solves batches of LPs over one system matrix ``W`` (m, n + m),
    each launch in the shape ``dense_launch_plan`` picks.  ``plan_shapes``
    counts this object's launches by shape, ``cluster_sizes`` by C,
    ``launch_lanes`` by (shape, C, lanes)."""

    kernel = "dense_simplex"
    plain = staticmethod(dense_lp_batch_ref)
    #: extra -D flags of the build this object launches (an instrumented
    #: variant of tools/k1_bench.py; empty in production)
    defines: tuple = ()

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.plan_shapes: Counter = Counter()
        self.cluster_sizes: Counter = Counter()
        self.launch_lanes: Counter = Counter()
        self._plans = {}  # lanes -> the plan picked for them
        self._checked = set()  # plans whose byte count the kernel confirmed

    @functools.cached_property
    def device_limits(self) -> tuple:
        """(shared bytes a block may opt into, SMs) of this object's card."""
        smem, sms = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(self.device):
            err = _dense_simplex_lib().dense_simplex_device_limits(
                ctypes.byref(smem), ctypes.byref(sms)
            )
        if err != 0:
            raise RuntimeError(f"K1: reading the card's limits failed: CUDA error {err}")
        return smem.value, sms.value

    @functools.cached_property
    def held(self) -> dict:
        """Clusters of each size C the card holds at once under the plan
        ``dense_plan_for`` gives that C (1: blocks of the block plan), for
        the shapes whose shared memory fits."""
        smem, _ = self.device_limits
        plans = {}
        for shape, C in [("block", 1)] + [("cluster", C) for C in dense_cluster_sizes(self.n + self.m)]:
            try:
                plans[C] = dense_plan_for(self.m, self.n, shape, C, smem)
            except ValueError:
                continue
        return {C: self.max_clusters(plan) for C, plan in plans.items()}

    def plan(self, lanes: int) -> DensePlan:
        """The launch ``dense_launch_plan`` picks for ``lanes`` lanes here
        (worked out once per lane count)."""
        if lanes not in self._plans:
            smem, sms = self.device_limits
            held = {} if dense_packs(self.m, self.n + self.m) else self.held
            self._plans[lanes] = dense_launch_plan(self.m, self.n, lanes, smem, sms, held)
        return self._plans[lanes]

    def max_clusters(self, plan: DensePlan) -> int:
        """How many clusters of ``plan`` (blocks, for C = 1) the card holds
        at once (asked once per plan and device)."""
        return _dense_max_clusters(self.device.index or 0, plan)

    def _launch(self, c, lo, hi, wb, wa, plan=None) -> LPOutcome:
        lib = _dense_simplex_variant(self.defines) if self.defines else _dense_simplex_lib()
        m, n = self.m, self.n
        B = c.shape[0]
        dev = self.device
        out = self._outputs(B)
        status, obj, x, basis, at_upper, iters = out
        if B == 0:
            return out
        if plan is None:
            plan = self.plan(B)
        if (plan.m, plan.nc) != (m, n + m):
            raise ValueError(f"{plan} is not a plan for {m} rows and {n + m} columns")
        if plan not in self._checked:
            kb = lib.dense_simplex_smem_bytes(plan.code, m, n, plan.C, plan.P)
            if kb != plan.smem_bytes:
                raise RuntimeError(f"K1 counts {kb} shared bytes for {plan}, the plan {plan.smem_bytes}")
            self._checked.add(plan)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.dense_simplex_launch(
                self.W.data_ptr(), m, n, B,
                c.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                wb.data_ptr(), wa.data_ptr(),
                self.max_iters, self.feas_tol, self.cost_tol, self.pivot_tol,
                plan.code, plan.C, plan.threads, plan.P,
                status.data_ptr(), obj.data_ptr(), x.data_ptr(),
                basis.data_ptr(), at_upper.data_ptr(), iters.data_ptr(),
                stream,
            )
        if err != 0:
            raise RuntimeError(f"K1 launch of {plan} failed: CUDA error {err}")
        self.launches += 1
        self.plan_shapes[plan.shape] += 1
        self.cluster_sizes[plan.C] += 1
        self.launch_lanes[plan.shape, plan.C, B] += 1
        LAUNCHES[self.kernel] += 1
        return out


class CudaRevBatch(_LPBatch):
    """K2, the revised simplex: the same contract, checks and counter as
    K1's ``CudaLPBatch``, one cluster of blocks per lane as
    ``rev_launch_plan`` says.  ``cluster_sizes`` counts this object's
    launches by C, ``launch_lanes`` by (C, lanes)."""

    kernel = "revised_simplex"
    plain = staticmethod(revised_lp_batch_ref)

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.cluster_sizes: Counter = Counter()
        self.launch_lanes: Counter = Counter()

    @functools.cached_property
    def device_limits(self) -> tuple:
        """(shared bytes a block may opt into, SMs) of this object's card."""
        lib = _revised_simplex_lib()
        smem, sms = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(self.device):
            err = lib.revised_simplex_device_limits(ctypes.byref(smem), ctypes.byref(sms))
        if err != 0:
            raise RuntimeError(f"K2: reading the card's limits failed: CUDA error {err}")
        return smem.value, sms.value

    @functools.cached_property
    def held(self) -> dict:
        """Clusters of each size C the card holds at once, each under the
        plan ``rev_plan_for`` gives that C."""
        smem, _ = self.device_limits
        return {
            C: self.max_clusters(rev_plan_for(self.m, self.n, C, smem))
            for C in cluster_sizes_for(self.n + self.m)
        }

    def plan(self, lanes: int) -> RevPlan:
        """The launch ``rev_launch_plan`` picks for ``lanes`` lanes here."""
        return rev_launch_plan(self.m, self.n, lanes, *self.device_limits, self.held)

    def max_clusters(self, plan: RevPlan) -> int:
        """How many clusters of ``plan`` the card holds at once (asked once
        per plan and device)."""
        return _rev_max_clusters(
            self.device.index or 0, self.m, self.n, plan.C, plan.threads,
            plan.w_smem, plan.bi_smem, plan.p1_smem,
        )

    def _launch(self, c, lo, hi, wb, wa, plan=None) -> LPOutcome:
        lib = _revised_simplex_lib()
        m, n = self.m, self.n
        B = c.shape[0]
        dev = self.device
        out = self._outputs(B)
        status, obj, x, basis, at_upper, iters = out
        if B == 0:
            return out
        if plan is None:
            plan = self.plan(B)
        if (plan.m, plan.nc) != (m, n + m):
            raise ValueError(f"{plan} is not a plan for {m} rows and {n + m} columns")
        kb = lib.revised_simplex_smem_bytes(
            m, n, plan.C, int(plan.w_smem), int(plan.bi_smem), int(plan.p1_smem)
        )
        if kb != plan.smem_bytes:
            raise RuntimeError(f"K2 counts {kb} shared bytes for {plan}, the plan {plan.smem_bytes}")
        blocks = B * plan.C

        def square():
            return torch.empty(blocks, m, m, dtype=torch.float32, device=dev)

        bi_scratch = None if plan.bi_smem else square()
        p1_scratch = None if plan.p1_smem else square()
        z_scratch = torch.empty(blocks, n + m, dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.revised_simplex_launch(
                self.W.data_ptr(), m, n, B,
                c.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                wb.data_ptr(), wa.data_ptr(),
                self.max_iters, self.feas_tol, self.cost_tol, self.pivot_tol,
                plan.C, plan.threads,
                int(plan.w_smem), int(plan.bi_smem), int(plan.p1_smem),
                bi_scratch.data_ptr() if bi_scratch is not None else None,
                p1_scratch.data_ptr() if p1_scratch is not None else None,
                z_scratch.data_ptr(),
                status.data_ptr(), obj.data_ptr(), x.data_ptr(),
                basis.data_ptr(), at_upper.data_ptr(), iters.data_ptr(),
                stream,
            )
        if err != 0:
            raise RuntimeError(f"K2 launch of {plan} failed: CUDA error {err}")
        self.launches += 1
        self.cluster_sizes[plan.C] += 1
        self.launch_lanes[plan.C, B] += 1
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

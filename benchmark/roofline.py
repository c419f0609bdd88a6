"""The card's published peaks and K6's and K4's least time, the benchmark's
copy.

The arithmetic is ``chip_smoke.lex_bound``'s and, for K4's bytes,
``chip_smoke.dp_bound``'s, as they stood when each entered the benchmark,
over NVIDIA's published H100 SXM peaks (data sheet, 700 W):
3.35 TB/s of HBM and 34 TFLOP/s of float64 outside the tensor cores.  A
share of this bound is stated with the card's power limit beside it."""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_F64_PER_S = 34e12


def k6_bytes(m: int, n: int, k: int, launches: int, lanes: int) -> float:
    """Bytes K6 has to move over ``launches`` launches holding ``lanes``
    lanes in all: W, the objectives and the bounds read once a launch, each
    lane's rhs and perm read once, its status, results, IPs, nodes and LP
    steps written once."""
    nc = n + m
    per_launch = 8 * (m * nc + k * n + 2 * n + 2 * (m - k)) + n + k
    per_lane = 8 * 2 * k + 4 + 8 * k + 4 + 8 + 8
    return float(per_launch * launches + per_lane * lanes)


def k6_flops(m: int, n: int, nodes: int, steps: int, pivots: int = 0) -> float:
    """Float64 operations K6 has to do: 2 m (n + m) a node for its start
    (the basic values), a step for pricing and a pivot for the rank-1
    update.  The card reports no pivots, so a caller that passes none
    counts a lower bound."""
    return float(nodes + steps + pivots) * 2 * m * (n + m)


def k4_bytes(table_cells: int, launches: int) -> float:
    """Bytes K4 has to move over ``launches`` passes of a table of
    ``table_cells`` int32 cells: each pass reads the previous table once and
    writes the next once (the shifted read of a cell's source is a second
    read of the same table, which the count leaves out)."""
    return 8.0 * table_cells * launches


def least_seconds(nbytes: float, flops: float) -> float:
    """The larger of the two times at the published peaks."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F64_PER_S)

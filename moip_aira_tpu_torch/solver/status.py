"""Solve status codes (the native analogue of CPLEX's CPXMIP_* statuses that
the reference branches on: CPXMIP_INFEASIBLE / CPXMIP_INForUNBD,
aira.cpp:489-492)."""

from __future__ import annotations

import enum


class SolveStatus(enum.IntEnum):
    OPTIMAL = 0
    INFEASIBLE = 1
    UNBOUNDED = 2
    ITERATION_LIMIT = 3
    NODE_LIMIT = 4

    @property
    def is_infeasible(self) -> bool:
        # The reference treats INForUNBD like INFEASIBLE (aira.cpp:489).
        return self in (SolveStatus.INFEASIBLE, SolveStatus.UNBOUNDED)

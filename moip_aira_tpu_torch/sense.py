"""Optimisation sense and infinity sentinel.

Reference parity: src/sense.h (enum Sense {MIN, MAX}) and the CPX_INFBOUND
(1e20) sentinel used throughout src/aira.cpp / src/problem.cpp.  Internally we
use IEEE infinity; the 1e20 sentinel only matters at the CPLEX API boundary,
which does not exist here.
"""

from __future__ import annotations

import enum
import math


class Sense(enum.IntEnum):
    MIN = 0
    MAX = 1

    def flip(self) -> "Sense":
        return Sense.MAX if self is Sense.MIN else Sense.MIN


#: Infinite bound. The reference uses CPX_INFBOUND == 1e20 (problem.cpp:126).
INF: float = math.inf


def worst(sense: Sense) -> float:
    """The 'no bound yet' value for a running best in the given sense."""
    return INF if sense is Sense.MIN else -INF

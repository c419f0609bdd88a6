"""Symmetric-group permutation tables in the reference's search order.

Reference parity: src/mk_symgroup.py (build-time codegen) + src/symgroup.h.
The reference generates all n! permutations in a specific "hopefully optimal"
order — a depth-first enumeration preferring *high* leading values, with each
completed sequence reversed (mk_symgroup.py:25-37) — and compiles them into
static tables.  Here they are generated on demand and cached; there is no
compile-time ``maxObjCount`` ceiling (the reference rejects objcnt >= 5 by
default, aira.cpp:230-233), though the factorial growth makes >10 objectives
impractical for the synergistic decomposition anyway.
"""

from __future__ import annotations

import functools
from math import factorial
from typing import List, Tuple


@functools.lru_cache(maxsize=None)
def sym_perms(n: int) -> Tuple[Tuple[int, ...], ...]:
    """All permutations of range(n), in the reference's order."""
    if n <= 1:
        return ((0,),) if n == 1 else ((0,),)

    out: List[Tuple[int, ...]] = []

    def rec(sofar: List[int]) -> None:
        if len(sofar) == n:
            out.append(tuple(reversed(sofar)))
            return
        for k in range(n - 1, -1, -1):
            if k not in sofar:
                rec(sofar + [k])

    rec([])
    assert len(out) == factorial(n)
    return tuple(out)


def max_workers(objcnt: int) -> int:
    """The synergistic decomposition cannot use more workers than orderings
    (reference aira.cpp:261-262 clamps num_threads to S[objcnt].size())."""
    return factorial(objcnt)

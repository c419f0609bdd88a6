"""Tracing / fine-timing instrumentation.

Reference parity: the compile-time ``#ifdef DEBUG`` / ``DEBUG_SYNC`` /
``DEBUG_SOLUTION_SEARCH`` blocks and the ``FINETIMING`` per-thread
cplex_time/wait_time accumulators (src/aira.cpp:25-27, 554-560, 1870-1876;
utils/threadsort.py regroups the interleaved output).  Here the same roles
are env-var gated at runtime:

* ``MOIP_TRACE=1``      — per-worker decision log (solve boxes, find hits,
                          state-machine transitions), already grouped per
                          worker so no threadsort.py equivalent is needed.
* ``MOIP_FINETIMING=1`` — accumulates device-solve / host-store / scheduling
                          time per round and prints a summary at exit.

Zero overhead when disabled (module-level booleans, no formatting work).
"""

from __future__ import annotations

import atexit
import os
import sys
import time
from collections import defaultdict
from typing import Dict

TRACE: bool = os.environ.get("MOIP_TRACE", "") not in ("", "0")
FINETIMING: bool = os.environ.get("MOIP_FINETIMING", "") not in ("", "0")


def trace(worker_id, msg: str) -> None:
    if TRACE:
        sys.stderr.write(f"[moip w{worker_id}] {msg}\n")


class Timings:
    """Per-phase wall-clock accumulators (FINETIMING equivalent)."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    class _Span:
        def __init__(self, owner: "Timings", key: str):
            self.owner = owner
            self.key = key

        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self.owner.totals[self.key] += time.perf_counter() - self.t0
            self.owner.counts[self.key] += 1
            return False

    def span(self, key: str) -> "_Span":
        return Timings._Span(self, key)

    def add(self, key: str, seconds: float) -> None:
        self.totals[key] += seconds
        self.counts[key] += 1

    def summary(self) -> str:
        rows = [
            f"  {k:<24} {self.totals[k]:9.3f}s  ({self.counts[k]} spans)"
            for k in sorted(self.totals)
        ]
        return "moip fine timing:\n" + "\n".join(rows)


GLOBAL_TIMINGS = Timings()

if FINETIMING:
    atexit.register(lambda: sys.stderr.write(GLOBAL_TIMINGS.summary() + "\n"))

"""Tracing and fine timing: the port's one recorder of spans and counters.

Reference parity: the compile-time ``#ifdef DEBUG`` / ``DEBUG_SYNC`` /
``DEBUG_SOLUTION_SEARCH`` blocks and the ``FINETIMING`` per-thread
cplex_time/wait_time accumulators (src/aira.cpp:25-27, 554-560, 1870-1876;
utils/threadsort.py regroups the interleaved output).  Here the same roles
are gated at runtime:

* ``MOIP_TRACE=1`` — per-worker decision log (solve boxes, find hits,
  state-machine transitions), already grouped per worker so no
  threadsort.py equivalent is needed.
* ``GLOBAL_TIMINGS`` — the recorder, kept in memory as aggregates (no
  per-event log, no file).  A span (``GLOBAL_TIMINGS.span(name)``, or the
  decorator ``spanned(name)``) records its count, its total seconds and
  its self seconds (the total less what its child spans cover, kept with a
  stack of open spans a thread) and the names of the spans it opened
  under; a counter (``GLOBAL_TIMINGS.count(name)``) records a count, and
  the decorator ``counted(name)`` also adds the seconds of each call of
  the function it wraps.  Both read one clock, ``time.perf_counter_ns``.

The recorder records only while it is on: under ``MOIP_FINETIMING=1``
(which also prints each span's and counter's count, total and self seconds
at exit), between ``enable()`` and ``disable()`` (or inside
``recording()``), or while a ``torch.profiler`` records.  While a profiler
records, each span also opens ``torch.profiler.record_function("moip." +
name)``, so that it lands in the profiler's trace as a ``user_annotation``
on the device's clock; counters stay off the timeline.  Off, a span or a
counter costs that check and one branch: it reads no clock and opens no
``record_function``.
"""

from __future__ import annotations

import atexit
import functools
import os
import sys
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Set

from torch.autograd import _profiler_enabled
from torch.profiler import record_function

TRACE: bool = os.environ.get("MOIP_TRACE", "") not in ("", "0")
FINETIMING: bool = os.environ.get("MOIP_FINETIMING", "") not in ("", "0")

#: the prefix of a span's name on a profiler's timeline
PREFIX = "moip."

_now = time.perf_counter_ns


def trace(worker_id, msg: str) -> None:
    if TRACE:
        sys.stderr.write(f"[moip w{worker_id}] {msg}\n")


class _Off:
    """What a span is while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("owner", "name", "parent", "child_ns", "mark", "t0")

    def __init__(self, owner: "Timings", name: str):
        self.owner = owner
        self.name = name

    def __enter__(self):
        stack = self.owner._stack()
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.child_ns = 0
        self.mark = None
        if _profiler_enabled():
            self.mark = record_function(PREFIX + self.name)
            self.mark.__enter__()
        self.t0 = _now()
        return self

    def __exit__(self, *exc):
        ns = _now() - self.t0
        if self.mark is not None:
            self.mark.__exit__(*exc)
        self.owner._stack().pop()
        o, name, parent = self.owner, self.name, self.parent
        o.totals[name] += ns * 1e-9
        o.self_s[name] += (ns - self.child_ns) * 1e-9
        o.counts[name] += 1
        if parent is not None:
            parent.child_ns += ns
            o.parents[name].add(parent.name)
        return False


class Timings:
    """The recorder: per-name counts and seconds (the FINETIMING
    equivalent).  ``totals`` holds the seconds of spans and timed counters,
    ``self_s`` a span's self seconds, ``counts`` how often each was
    recorded, ``parents`` the spans each span opened under."""

    def __init__(self) -> None:
        self.enabled = FINETIMING
        self.totals: Dict[str, float] = defaultdict(float)
        self.self_s: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.parents: Dict[str, Set[str]] = defaultdict(set)
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str):
        """A context manager timing ``name``."""
        if not (self.enabled or _profiler_enabled()):
            return _OFF
        return _Span(self, name)

    def count(self, name: str, n: int = 1) -> None:
        if self.enabled or _profiler_enabled():
            self.counts[name] += n

    def add(self, name: str, seconds: float) -> None:
        """Count ``name`` once and add ``seconds`` the caller measured."""
        if self.enabled or _profiler_enabled():
            self.totals[name] += seconds
            self.counts[name] += 1

    def clear(self) -> None:
        for table in (self.totals, self.self_s, self.counts, self.parents):
            table.clear()

    def summary(self) -> str:
        rows = []
        for k in sorted(self.counts):
            total = f"{self.totals[k]:9.3f}s" if k in self.totals else f"{'-':>10}"
            own = f"{self.self_s[k]:9.3f}s" if k in self.self_s else f"{'-':>10}"
            rows.append(f"  {k:<24} {self.counts[k]:>9}  {total}  {own}")
        head = f"  {'name':<24} {'count':>9}  {'total':>10}  {'self':>10}"
        return "moip fine timing:\n" + "\n".join([head] + rows)


GLOBAL_TIMINGS = Timings()


def enable() -> None:
    GLOBAL_TIMINGS.enabled = True


def disable() -> None:
    GLOBAL_TIMINGS.enabled = False


@contextmanager
def recording():
    """The recorder on inside the block (and as it was after it)."""
    was = GLOBAL_TIMINGS.enabled
    GLOBAL_TIMINGS.enabled = True
    try:
        yield GLOBAL_TIMINGS
    finally:
        GLOBAL_TIMINGS.enabled = was


def spanned(name: str):
    """Decorator: each call of the function is the span ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with GLOBAL_TIMINGS.span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def counted(name: str):
    """Decorator: each call of the function counts ``name`` once and adds
    its seconds, off the timeline."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            rec = GLOBAL_TIMINGS
            if not (rec.enabled or _profiler_enabled()):
                return fn(*args, **kwargs)
            t0 = _now()
            try:
                return fn(*args, **kwargs)
            finally:
                rec.totals[name] += (_now() - t0) * 1e-9
                rec.counts[name] += 1

        return inner

    return wrap


if FINETIMING:
    atexit.register(lambda: sys.stderr.write(GLOBAL_TIMINGS.summary() + "\n"))

"""Worker descriptors and shared bound cells.

Reference parity: src/thread.{h,cpp} (the ``Thread`` descriptor) and
src/lockingvars.h (``Locking_Vars``).

The reference shares bounds through raw ``int*`` cells guarded by a mutex +
condvar object whose wait logic is vestigial (SURVEY §2/C8: ``add_state`` is
never called so every thread takes the non-blocking "last in" branch).  The
rebuilt engine runs workers as cooperative state machines inside a
bulk-synchronous scheduler, so the cells become plain Python value holders
mutated deterministically between device solve rounds — and on a multi-chip
mesh they become rows of a device-resident bounds array combined with
min/max collectives (see parallel/mesh.py).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from moip_aira_tpu_torch.sense import INF


class Cell:
    """A shared bound cell (reference: the `new int` cells, cluster.cpp:62-64)."""

    __slots__ = ("value",)

    def __init__(self, value: float):
        self.value = value

    def __repr__(self) -> str:
        return f"Cell({self.value})"


class LockGroup:
    """Reference ``Locking_Vars`` (lockingvars.h:19-67) minus the vestigial
    condvar plumbing: only the flags that carry algorithmic meaning survive."""

    __slots__ = ("found_any", "changed")

    def __init__(self) -> None:
        self.found_any = False
        self.changed = False


@dataclasses.dataclass
class WorkerSpec:
    """Per-worker specification (reference src/thread.h:10-45)."""

    id: int
    #: how many leading objectives of ``perm`` this worker actively optimises
    nobj: int
    #: full permutation of range(objcnt), most significant first
    perm: List[int]
    #: per-objective shared cells; None = not shared (thread.h:14-17)
    share_to: List[Optional[Cell]]
    share_from: List[Optional[Cell]]
    share_bounds: List[Optional[Cell]]
    share_limit: List[Optional[Cell]]
    locks: List[Optional[LockGroup]]
    partnered: bool = False
    #: EPP strip range (thread.h:23-24); only meaningful when split=True
    split: bool = False
    split_start: float = 0.0
    split_stop: float = 0.0

    @property
    def sharing(self) -> bool:
        # reference: `const bool sharing = (t->share_to != nullptr)` — the
        # synergistic ctor always allocates the tables, the split ctor does
        # not (thread.cpp:124-133), so sharing == not split.
        return not self.split

    @classmethod
    def for_split(
        cls, wid: int, nobj: int, objcnt: int, start: float, stop: float
    ) -> "WorkerSpec":
        """EPP worker: identity permutation, no sharing (thread.cpp:124-133)."""
        none: List[Optional[Cell]] = [None] * objcnt
        return cls(
            id=wid,
            nobj=nobj,
            perm=list(range(objcnt)),
            share_to=list(none),
            share_from=list(none),
            share_bounds=list(none),
            share_limit=list(none),
            locks=[None] * objcnt,
            split=True,
            split_start=start,
            split_stop=stop,
        )

    @classmethod
    def serial(cls, objcnt: int) -> "WorkerSpec":
        """A single unshared worker over the identity permutation."""
        none: List[Optional[Cell]] = [None] * objcnt
        w = cls(
            id=0,
            nobj=objcnt,
            perm=list(range(objcnt)),
            share_to=list(none),
            share_from=list(none),
            share_bounds=list(none),
            share_limit=list(none),
            locks=[None] * objcnt,
        )
        return w

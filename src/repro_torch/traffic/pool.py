"""Pooled slot state: free-list admission over a preallocated slot batch.

The recurrent families this repo serves keep O(1) state per sequence (the
LSTM's (c, h) plus the optional delta reference/partial-sum memory), so a
slot costs a few KB — hundreds of slots are cheap where a paged-KV
transformer would page. The device arrays themselves are preallocated once
by the scheduler (`init_cache(slots, ...)`); this module owns the HOST side
of the pool: which slots are free, which request occupies each busy slot,
and the per-occupant accounting (budget left, deadline, admission time)
that admission/eviction decisions read.

The contract with the scheduler:

  alloc()/alloc_many(k)  → slot indices off the free list (LIFO — recently
                           freed slots rejoin first, keeping the active set
                           dense for occupancy reporting)
  seat(slot, info)       → record the occupant (the device-side join runs
                           separately; the pool never touches arrays)
  free(slot)             → evict: the occupant record is dropped and the
                           slot returns to the free list
  info(slot)/owner(slot) → the occupant record / its uid (None when free)
"""
from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["SlotInfo", "SlotPool"]


@dataclasses.dataclass
class SlotInfo:
    """Host-side record of one admitted request while it occupies a slot."""
    uid: int
    prompt_len: int
    remaining: int              # tokens still owed (budget minus emitted)
    deadline: float | None = None   # absolute clock time; None = none
    priority: int = 0
    admitted_at: float = 0.0
    emitted: int = 0            # tokens harvested so far
    extra: Any = None
    slot: int = -1              # seat() fills this backref in


class SlotPool:
    """Free-list over ``n`` preallocated decode slots."""

    def __init__(self, n: int):
        if n <= 0:
            raise ValueError(f"slot pool needs n > 0, got {n}")
        self.n = n
        self._free: list[int] = list(range(n - 1, -1, -1))
        self._info: list[SlotInfo | None] = [None] * n

    # ------------------------------------------------------------- alloc
    @property
    def free_count(self) -> int:
        return len(self._free)

    def alloc(self) -> int | None:
        """Pop one free slot (None when the pool is exhausted)."""
        return self._free.pop() if self._free else None

    def alloc_many(self, k: int) -> list[int]:
        """Pop up to ``k`` free slots."""
        out = []
        while self._free and len(out) < k:
            out.append(self._free.pop())
        return out

    def seat(self, slot: int, info: SlotInfo) -> None:
        if self._info[slot] is not None:
            raise RuntimeError(f"slot {slot} already seated "
                               f"(uid {self._info[slot].uid})")
        info.slot = slot
        self._info[slot] = info

    def free(self, slot: int) -> SlotInfo:
        """Evict the occupant; the slot rejoins the free list."""
        info = self._info[slot]
        if info is None:
            raise RuntimeError(f"slot {slot} is already free")
        self._info[slot] = None
        self._free.append(slot)
        return info

    def release_unseated(self, slot: int) -> None:
        """Return a slot popped by alloc() but never seated (a prefill
        group came up short)."""
        if self._info[slot] is not None:
            raise RuntimeError(f"slot {slot} is seated — use free()")
        self._free.append(slot)

    # ------------------------------------------------------------ queries
    def info(self, slot: int) -> SlotInfo | None:
        return self._info[slot]

    def owner(self, slot: int) -> int | None:
        info = self._info[slot]
        return None if info is None else info.uid

    def owners(self) -> list[int | None]:
        """Slot → uid (None when free), the dispatch-time snapshot the
        scheduler attaches to every in-flight chunk."""
        return [None if i is None else i.uid for i in self._info]

    def active(self) -> list[int]:
        """Busy slot indices, ascending."""
        return [s for s, i in enumerate(self._info) if i is not None]

    def __len__(self) -> int:
        return self.n - len(self._free)

    def __repr__(self) -> str:
        return f"SlotPool({len(self)}/{self.n} busy)"

"""Priority/deadline admission: who decodes next, who is shed under load.

The queue orders waiting requests by (priority desc, deadline asc, arrival
asc) — a deadline-monotonic ordering within each priority band. Overload
degrades gracefully instead of queueing unboundedly: with ``max_queue``
set, pushing into a full queue sheds the WORST waiting request (lowest
priority, latest deadline) — the incoming request itself when it is the
worst — and the shed request surfaces as a ``rejected`` outcome rather
than silently timing out. Requests whose deadline passes while queued are
dropped at admission time (``expired``); the scheduler additionally evicts
past-deadline work already holding a slot.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Any

__all__ = ["QueuedRequest", "AdmissionQueue"]


@dataclasses.dataclass
class QueuedRequest:
    uid: int
    prompt: Any                  # (1, S) int32 tokens (or (1, S, X) frames)
    prompt_len: int
    max_new: int
    extra: Any = None
    deadline: float | None = None    # absolute clock time; None = none
    priority: int = 0                # higher = sooner
    arrival: float = 0.0

    def sort_key(self):
        return (-self.priority,
                self.deadline if self.deadline is not None else math.inf,
                self.arrival, self.uid)


class AdmissionQueue:
    """Sorted admission queue with bounded depth and deadline expiry."""

    def __init__(self, max_queue: int | None = None):
        if max_queue is not None and max_queue <= 0:
            raise ValueError(f"max_queue must be positive, got {max_queue}")
        self.max_queue = max_queue
        self._q: list[tuple] = []       # (sort_key, QueuedRequest)

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)

    def push(self, req: QueuedRequest) -> QueuedRequest | None:
        """Enqueue; returns the request shed by overload (possibly ``req``
        itself), or None when everything fits."""
        bisect.insort(self._q, (req.sort_key(), req))
        if self.max_queue is not None and len(self._q) > self.max_queue:
            return self._q.pop()[1]     # worst = last in sorted order
        return None

    def expire(self, now: float) -> list[QueuedRequest]:
        """Drop every queued request whose deadline has already passed —
        admitting it could only produce late tokens."""
        expired = [r for _, r in self._q
                   if r.deadline is not None and now > r.deadline]
        if expired:
            gone = {r.uid for r in expired}
            self._q = [e for e in self._q if e[1].uid not in gone]
        return expired

    def pop(self, k: int) -> list[QueuedRequest]:
        """Dequeue up to ``k`` requests in admission order."""
        take, self._q = self._q[:k], self._q[k:]
        return [r for _, r in take]

    def peek(self) -> QueuedRequest | None:
        return self._q[0][1] if self._q else None

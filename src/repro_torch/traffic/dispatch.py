"""Dispatch-ahead bookkeeping: the host runs chunks ahead of its syncs.

A CUDA graph replay returns as soon as it is enqueued, and the card works
through its stream in order. The scheduler exploits that the way the
paper's accelerator overlaps its modules: it enqueues decode chunk N+1
(and any slot joins that precede it) BEFORE forcing chunk N's tokens to
the host, so the device never idles across the host's per-chunk
bookkeeping (token collection, EOS scanning, admission decisions, Python
object churn):

    device:  [ chunk N ][ joins ][ chunk N+1 ][ joins ][ chunk N+2 ] …
    host:         │ dispatch N+1 ──┘               │
                  └ harvest N (the one sync) ──────┴ harvest N+1 …

A replay writes its tokens into the graph's one static token buffer, which
the next replay overwrites, so each dispatch copies that buffer (and the
counter vector) into the chunk's own buffer right after its replay and
records a CUDA event there (`InFlight.tokens`, `InFlight.event`); the
harvest waits on that event alone, the oldest chunk's.

Each dispatched chunk carries a host-side snapshot of slot ownership at
dispatch time (`InFlight.owners`): by the time its tokens are harvested,
a slot may have been evicted and re-seated, and the tokens must be
credited to the request that actually occupied the slot when the chunk
was enqueued. Correctness never depends on the lag: the device-resident
``done``/``budget`` vectors freeze finished slots inside the chunk
itself, and a join fully overwrites a slot's state before reuse, so the
decoded trajectory of every request is bit-identical to the synchronous
(depth-1) schedule.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any

__all__ = ["InFlight", "DispatchQueue"]


@dataclasses.dataclass
class InFlight:
    """One dispatched-but-unharvested decode chunk."""
    tokens: Any                 # (slots, chunk) int32 tensor: this
                                # chunk's own copy of the static buffer
    owners: tuple               # slot → uid (None = idle) at dispatch time
    seq: int                    # dispatch sequence number
    counters: Any = None        # obs counter vector snapshot — rides the
                                # chunk so the host reads it at the SAME
                                # sync that waits for the tokens
    event: Any = None           # CUDA event recorded after the copies
                                # (None on the CPU, where nothing is async)


class DispatchQueue:
    """FIFO of in-flight chunks, at most ``depth`` deep.

    depth=1 is the synchronous baseline (dispatch, then immediately
    harvest); depth=2 is classic double buffering (harvest chunk N with
    chunk N+1 already queued on the device). Deeper pipelines trade
    eviction/admission latency (a freed slot re-seats one chunk later per
    level) for more host/device overlap.
    """

    def __init__(self, depth: int = 2):
        if depth < 1:
            raise ValueError(f"dispatch depth must be >= 1, got {depth}")
        self.depth = depth
        self._q: deque[InFlight] = deque()
        self._seq = 0

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)

    @property
    def want_dispatch(self) -> bool:
        """Whether another chunk should be enqueued before harvesting."""
        return len(self._q) < self.depth

    def push(self, tokens, owners, counters=None, event=None) -> InFlight:
        if len(self._q) >= self.depth:
            raise RuntimeError(f"dispatch queue full (depth {self.depth})")
        inf = InFlight(tokens, tuple(owners), self._seq, counters, event)
        self._seq += 1
        self._q.append(inf)
        return inf

    def harvest(self) -> InFlight | None:
        """Pop the oldest in-flight chunk (the host then waits on its
        event). Returns None when nothing is in flight."""
        return self._q.popleft() if self._q else None

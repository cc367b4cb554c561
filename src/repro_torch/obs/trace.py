"""Span tracer for the serving stack — Chrome-trace/Perfetto export.

One global host-side tracer instruments the serving path (`ServeEngine`
prepare/prefill/decode, the continuous-batching scheduler's
admit/dispatch/harvest/evict, and `repro_torch.spec`'s
propose/verify/rollback). The contract:

- **Disabled is the default and costs (near) nothing.** ``span()`` on a
  disabled tracer returns one shared no-op context manager — a single
  attribute check and no allocation — so instrumented hot paths are
  unchanged when nobody is looking. A host-side span never perturbs a
  decoded trajectory, enabled or not.
- **Spans are host-wall-clock.** Device work is asynchronous; a span
  around a dispatch measures the host's enqueue cost, a span around a
  harvest measures the true sync wait. Spans inside a body that a CUDA
  graph captures (the spec propose/verify/rollback) fire once per
  CAPTURE, not per replay, on the card (once per round on the CPU, where
  the body runs eagerly): they chart the capture's cost.
- **Export is standard Chrome trace JSON** (``chrome://tracing`` /
  Perfetto): complete ``"X"`` events with microsecond ``ts``/``dur``,
  sorted by ``ts``, one pid per process and the Python thread id as
  ``tid``. ``validate()`` checks well-formedness: sorted timestamps,
  matched B/E nesting, non-negative X durations.

Usage::

    from repro_torch.obs import trace
    trace.enable()
    with trace.span("serve.generate", steps=32):
        ...
    trace.save("trace.json")

or as a decorator::

    @trace.traced("engine.prepare")
    def prepare(...): ...
"""
from __future__ import annotations

import functools
import json
import os
import sys
import threading
import time

__all__ = ["Tracer", "get_tracer", "enable", "disable", "span", "instant",
           "traced", "save", "validate", "validate_file"]


class _NullSpan:
    """Shared no-op context manager — the disabled-tracer fast path."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "name", "cat", "args", "_t0")

    def __init__(self, tracer, name, cat, args):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        self._t0 = self._tracer._now_us()
        return self

    def __exit__(self, *exc):
        t1 = self._tracer._now_us()
        ev = {"name": self.name, "cat": self.cat, "ph": "X",
              "ts": self._t0, "dur": t1 - self._t0,
              "pid": self._tracer.pid,
              "tid": threading.get_ident() & 0xFFFF}
        if self.args:
            ev["args"] = self.args
        self._tracer.events.append(ev)
        return False


class Tracer:
    """Span recorder with a near-zero-cost disabled path.

    ``span(name, **args)`` returns a context manager; on exit it appends
    one complete ("X") Chrome-trace event. Timestamps are microseconds
    since the tracer's epoch (``perf_counter`` based, monotonic).
    """

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.events: list[dict] = []
        self.pid = os.getpid()
        self._epoch = time.perf_counter()

    def _now_us(self) -> float:
        return (time.perf_counter() - self._epoch) * 1e6

    def span(self, name: str, cat: str = "obs", **args):
        if not self.enabled:
            return _NULL
        return _Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "obs", **args):
        """Record a zero-duration instant event."""
        if not self.enabled:
            return
        ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
              "ts": self._now_us(), "pid": self.pid,
              "tid": threading.get_ident() & 0xFFFF}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def clear(self):
        self.events = []
        self._epoch = time.perf_counter()

    def export(self) -> dict:
        """Chrome trace JSON object (events sorted by ts)."""
        return {"traceEvents": sorted(self.events, key=lambda e: e["ts"]),
                "displayTimeUnit": "ms"}

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(self.export(), f, indent=1)
            f.write("\n")


# ------------------------------------------------------------ global API
_TRACER = Tracer(enabled=False)


def get_tracer() -> Tracer:
    return _TRACER


def enable(clear: bool = True):
    """Turn the global tracer on (optionally dropping prior events)."""
    if clear:
        _TRACER.clear()
    _TRACER.enabled = True
    return _TRACER


def disable():
    _TRACER.enabled = False


def span(name: str, cat: str = "obs", **args):
    """Span on the global tracer (no-op singleton when disabled)."""
    if not _TRACER.enabled:        # inlined fast path: one check, no alloc
        return _NULL
    return _Span(_TRACER, name, cat, args)


def instant(name: str, cat: str = "obs", **args):
    if _TRACER.enabled:
        _TRACER.instant(name, cat, **args)


def traced(name: str | None = None, cat: str = "obs"):
    """Decorator form: ``@traced("engine.prepare")``."""
    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if not _TRACER.enabled:
                return fn(*a, **kw)
            with _TRACER.span(label, cat):
                return fn(*a, **kw)
        return wrapper
    return deco


def save(path: str):
    _TRACER.save(path)


# -------------------------------------------------------------- validate
def validate(payload) -> list[str]:
    """Well-formedness problems of a Chrome-trace JSON object (or event
    list). Empty list = valid. Checked: the event-array shape, known
    phases, per-event required keys, globally sorted ``ts``, non-negative
    ``dur`` on complete events, and matched B/E nesting per (pid, tid).
    """
    problems: list[str] = []
    events = payload.get("traceEvents") if isinstance(payload, dict) \
        else payload
    if not isinstance(events, list):
        return ["traceEvents is not a list"]
    last_ts = None
    stacks: dict[tuple, list[str]] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph == "M":               # metadata events carry no timestamp
            continue
        if ph not in ("X", "B", "E", "i", "I", "C"):
            problems.append(f"event {i}: unknown phase {ph!r}")
            continue
        for key in ("name", "ts", "pid", "tid"):
            if key not in ev:
                problems.append(f"event {i}: missing {key!r}")
        ts = ev.get("ts")
        if isinstance(ts, (int, float)):
            if last_ts is not None and ts < last_ts:
                problems.append(f"event {i}: ts not sorted "
                                f"({ts} after {last_ts})")
            last_ts = ts
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i}: X event needs dur >= 0, "
                                f"got {dur!r}")
        elif ph == "B":
            stacks.setdefault((ev.get("pid"), ev.get("tid")),
                              []).append(ev.get("name"))
        elif ph == "E":
            stack = stacks.setdefault((ev.get("pid"), ev.get("tid")), [])
            if not stack:
                problems.append(f"event {i}: E without matching B")
            else:
                stack.pop()
    for key, stack in stacks.items():
        if stack:
            problems.append(f"unclosed B events on {key}: {stack}")
    return problems


def validate_file(path: str) -> list[str]:
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, ValueError) as e:
        return [f"{path}: unreadable trace JSON ({e})"]
    return validate(payload)


def main(argv=None) -> int:
    """CLI gate: ``python -m repro_torch.obs.trace FILE [FILE...]`` exits
    non-zero (listing problems) unless every file is a well-formed
    Chrome trace with at least one event."""
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m repro_torch.obs.trace FILE [FILE...]",
              file=sys.stderr)
        return 2
    bad = 0
    for path in argv:
        problems = validate_file(path)
        try:
            with open(path) as f:
                n = len(json.load(f).get("traceEvents", []))
        except (OSError, ValueError):
            n = 0
        if not problems and n == 0:
            problems = ["no trace events recorded"]
        if problems:
            bad += 1
            for p in problems:
                print(f"{path}: {p}", file=sys.stderr)
        else:
            print(f"{path}: OK ({n} events)")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

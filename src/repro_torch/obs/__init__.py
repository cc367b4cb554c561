"""Observability for the port's serving stack.

- ``trace``: host-side span tracer (Chrome-trace/Perfetto export) with a
  near-zero-cost disabled path, instrumented across ServeEngine, the
  continuous-batching scheduler and ``repro_torch.spec``.
- ``counters``: an on-device float32 counter vector (decode steps,
  emitted tokens, spec acceptance, delta fired-column gauges) that the
  scheduler's captured chunk updates in place and that the host reads at
  the chunk's existing harvest: no extra device→host transfer.
- ``metrics``: counter/gauge/histogram registry with Prometheus-text and
  JSON dumps, absorbing traffic records, spec stats and device counters.
- ``scorecard``: achieved vs. roofline-bound effective GOPS and
  bytes/token, joining harvested counters with the card's constants
  (``repro_torch.hw``).
- ``collectives``: the per-step collective inventory of sharded serving
  (a step run once under torch.profiler, its c10d collectives counted).
"""
import importlib

__all__ = ["collectives", "counters", "metrics", "scorecard", "trace",
           "MetricsRegistry", "enable_tracing", "span", "traced"]

_LAZY = {"MetricsRegistry": ("metrics", "MetricsRegistry"),
         "enable_tracing": ("trace", "enable"),
         "span": ("trace", "span"),
         "traced": ("trace", "traced")}
_SUBMODULES = ("collectives", "counters", "metrics", "scorecard", "trace")


def __getattr__(name):
    # lazy: the scheduler imports this package on every serve, and
    # ``python -m repro_torch.obs.trace`` must not double-import its module
    if name in _SUBMODULES:
        return importlib.import_module("." + name, __name__)
    if name in _LAZY:
        mod, attr = _LAZY[name]
        return getattr(importlib.import_module("." + mod, __name__), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

"""Metrics registry: counters/gauges/histograms with Prometheus + JSON dump.

A copy of the reference's ``repro/obs/metrics.py`` (plain Python: it
imports only ``json`` and ``math``). The serving stack's scattered
accounting — ``traffic.metrics`` request
records, the scheduler's ``spec_stats()``, the harvested on-device
counter vector (``obs.counters``) — lands in one registry that exports
either Prometheus text exposition (scrape-ready) or a JSON object
(``BENCH``-style machine-readable). Absorb helpers keep the producers
decoupled: they only ever hand over plain records/dicts.

>>> reg = MetricsRegistry()
>>> reg.counter("requests_total", "requests served").inc(3)
>>> reg.gauge("slots_active").set(2)
>>> h = reg.histogram("ttft_ms", buckets=(1, 10, 100))
>>> h.observe(5.0)
>>> "requests_total 3" in reg.to_prometheus()
True
>>> reg.to_json()["ttft_ms"]["count"]
1
"""
from __future__ import annotations

import json
import math

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_LATENCY_BUCKETS_MS"]

# powers-of-~3 ms ladder: sub-ms kernels through multi-second queueing
DEFAULT_LATENCY_BUCKETS_MS = (1, 2, 5, 10, 20, 50, 100, 200, 500,
                              1000, 2000, 5000)


class Counter:
    """Monotonically increasing count."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.value = 0.0

    def inc(self, amount: float = 1.0):
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative inc {amount}")
        self.value += amount

    def to_json(self):
        return {"type": "counter", "value": self.value}

    def expose(self) -> list[str]:
        return [f"{self.name} {_fmt(self.value)}"]


class Gauge:
    """Point-in-time value (may go up or down)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.value = 0.0

    def set(self, value: float):
        self.value = float(value)

    def to_json(self):
        return {"type": "gauge", "value": self.value}

    def expose(self) -> list[str]:
        return [f"{self.name} {_fmt(self.value)}"]


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics: each bucket
    counts observations ≤ its upper bound; +Inf is implicit)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets=DEFAULT_LATENCY_BUCKETS_MS):
        self.name, self.help = name, help
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self.counts = [0] * (len(self.buckets) + 1)      # +Inf last
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float):
        value = float(value)
        if math.isnan(value):
            return                   # NaN observations are dropped, not
        self.sum += value            # propagated into the exposition
        self.count += 1
        for i, ub in enumerate(self.buckets):
            if value <= ub:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def to_json(self):
        cum = []
        running = 0
        for c in self.counts:
            running += c
            cum.append(running)
        return {"type": "histogram", "sum": self.sum, "count": self.count,
                "buckets": [{"le": ub, "count": n}
                            for ub, n in zip(self.buckets, cum[:-1])]
                + [{"le": "+Inf", "count": cum[-1]}]}

    def expose(self) -> list[str]:
        lines = []
        running = 0
        for ub, c in zip(self.buckets, self.counts):
            running += c
            lines.append(f'{self.name}_bucket{{le="{_fmt(ub)}"}} {running}')
        running += self.counts[-1]
        lines.append(f'{self.name}_bucket{{le="+Inf"}} {running}')
        lines.append(f"{self.name}_sum {_fmt(self.sum)}")
        lines.append(f"{self.name}_count {self.count}")
        return lines


def _fmt(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(float(v))


class MetricsRegistry:
    """Named metric store; get-or-create accessors, two export formats."""

    def __init__(self):
        self._metrics: dict[str, object] = {}

    def _get(self, cls, name, *args, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, *args, **kw)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets=DEFAULT_LATENCY_BUCKETS_MS) -> Histogram:
        return self._get(Histogram, name, help, buckets)

    def __contains__(self, name):
        return name in self._metrics

    def __getitem__(self, name):
        return self._metrics[name]

    # -------------------------------------------------------- absorbers
    def absorb_traffic(self, records, summary: dict | None = None):
        """Fold ``traffic.metrics.RequestRecord``s (and optionally their
        ``summarize`` output) into request counters + latency histograms.
        Records with no TTFT/TPOT (rejected, 0/1-token completions)
        contribute to outcome counts only — never NaN observations."""
        outcomes = self.counter("serve_requests_total",
                                "requests with a final outcome")
        tok = self.counter("serve_tokens_total", "tokens emitted")
        ttft = self.histogram("serve_ttft_ms", "time to first token")
        tpot = self.histogram("serve_tpot_ms", "per-token latency")
        for r in records:
            outcomes.inc()
            self.counter(f"serve_requests_{r.reason or 'unknown'}").inc()
            tok.inc(r.tokens)
            if r.ttft is not None:
                ttft.observe(r.ttft * 1e3)
            if r.tpot is not None:
                tpot.observe(r.tpot * 1e3)
        if summary:
            for key in ("toks_per_s", "goodput_tps", "wall_s"):
                if summary.get(key) is not None:
                    self.gauge(f"serve_{key}").set(summary[key])

    def absorb_spec(self, stats: dict | None):
        """Fold a scheduler ``spec_stats()`` dict (no-op on None)."""
        if not stats:
            return
        for key in ("rounds", "drafted", "accepted"):
            self.counter(f"spec_{key}_total").inc(stats[key])
        self.gauge("spec_acceptance_rate").set(stats["acceptance_rate"])

    def absorb_counters(self, counters: dict | None, prefix: str = "dev_"):
        """Fold a harvested on-device counter dict (``obs.counters``)."""
        if not counters:
            return
        for name, value in counters.items():
            self.gauge(prefix + name).set(value)

    # ---------------------------------------------------------- exports
    def to_prometheus(self) -> str:
        lines = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            lines.extend(m.expose())
        return "\n".join(lines) + "\n"

    def to_json(self) -> dict:
        return {name: self._metrics[name].to_json()
                for name in sorted(self._metrics)}

    def dump(self, path: str):
        """Write by extension: ``.json`` → JSON object, anything else →
        Prometheus text exposition. Never emits NaN (json strict)."""
        if path.endswith(".json"):
            with open(path, "w") as f:
                json.dump(self.to_json(), f, indent=2, allow_nan=False)
                f.write("\n")
        else:
            with open(path, "w") as f:
                f.write(self.to_prometheus())

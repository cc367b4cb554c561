"""Per-request latency accounting and the serving-curve reduction.

One ``RequestRecord`` per request, timestamped by the driver (the load
generator or a user callback): scheduled arrival, first harvested token
(TTFT measures from the SCHEDULED arrival, so queueing delay counts —
that is what a user of an overloaded service experiences), finish, token
count, and outcome. ``summarize`` reduces a batch of records to the
figures the benchmark record carries: p50/p90/p99 TTFT, per-token latency
(TPOT = (finish − first token)/(n − 1) per request), completion/shed
counts, throughput, and goodput (tokens of requests that completed within
their deadline — the honest numerator under overload).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["RequestRecord", "percentile", "summarize"]


@dataclasses.dataclass
class RequestRecord:
    uid: int
    scheduled: float                 # arrival per the trace (absolute)
    prompt_len: int = 0
    max_new: int = 0
    deadline: float | None = None    # absolute; None = no deadline
    submitted: float | None = None   # when the driver called submit()
    first_token: float | None = None
    finished: float | None = None
    tokens: int = 0
    reason: str = ""                 # done | expired | rejected

    @property
    def ttft(self) -> float | None:
        if self.first_token is None:
            return None
        return self.first_token - self.scheduled

    @property
    def tpot(self) -> float | None:
        """Mean per-token latency after the first token."""
        if (self.first_token is None or self.finished is None
                or self.tokens < 2):
            return None
        return (self.finished - self.first_token) / (self.tokens - 1)

    @property
    def in_deadline(self) -> bool:
        """Completed, and on time if a deadline was attached."""
        if self.reason != "done" or self.finished is None:
            return False
        return self.deadline is None or self.finished <= self.deadline


def percentile(xs, q: float) -> float:
    """Linear-interpolated percentile; nan on empty input."""
    xs = np.asarray(list(xs), np.float64)
    if xs.size == 0:
        return float("nan")
    return float(np.percentile(xs, q))


def _pct_ms(xs, q: float) -> float | None:
    """Percentile in ms, or None on empty input — summaries land in JSON
    benchmark records, and NaN is not valid JSON (json.dump with
    allow_nan=False rejects it; other parsers read a corrupt file)."""
    p = percentile(xs, q)
    return None if np.isnan(p) else round(p * 1e3, 3)


def summarize(records, wall: float, offered_rps: float | None = None) -> dict:
    """Reduce request records to the serving curve's figures.

    ``wall``: driver wall time (seconds) over which ``records`` were
    served; ``offered_rps``: the trace's offered load, carried through for
    the goodput-vs-offered-load curve. Latencies are reported in ms.
    """
    recs = list(records)
    ttfts = [r.ttft for r in recs if r.ttft is not None]
    tpots = [r.tpot for r in recs if r.tpot is not None]
    done = [r for r in recs if r.reason == "done"]
    total_tokens = sum(r.tokens for r in recs)
    good_tokens = sum(r.tokens for r in recs if r.in_deadline)
    out = {
        "requests": len(recs),
        "completed": len(done),
        "expired": sum(r.reason == "expired" for r in recs),
        "rejected": sum(r.reason == "rejected" for r in recs),
        "tokens": total_tokens,
        "wall_s": round(float(wall), 6),
        "p50_ttft_ms": _pct_ms(ttfts, 50),
        "p90_ttft_ms": _pct_ms(ttfts, 90),
        "p99_ttft_ms": _pct_ms(ttfts, 99),
        "p50_tpot_ms": _pct_ms(tpots, 50),
        "p99_tpot_ms": _pct_ms(tpots, 99),
        "toks_per_s": round(total_tokens / wall, 1) if wall > 0 else 0.0,
        "goodput_tps": round(good_tokens / wall, 1) if wall > 0 else 0.0,
    }
    if offered_rps is not None:
        out["offered_rps"] = round(float(offered_rps), 3)
    return out

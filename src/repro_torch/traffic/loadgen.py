"""Poisson load generator: offered traffic as a deterministic trace.

``poisson_trace`` draws the whole arrival schedule — exponential
inter-arrival gaps at the offered rate, a short/long prompt-length
mixture, ragged output budgets, optional relative deadlines and priority
bands — from one seeded ``numpy`` generator. No wall clock touches the
schedule, so the same config always produces the same trace: traffic runs
are reproducible and their figures compare across commits.

``serve_trace`` drives a ContinuousBatchingEngine through a trace and
timestamps every request (submit, first token via the engine's per-token
callback, finish) into ``metrics.RequestRecord``s:

- ``realtime=True`` paces submissions on the host clock — offered load is
  the trace's; the engine queues/sheds as it would in production.
- ``realtime=False`` ignores pacing and feeds arrivals as fast as the
  engine admits them — a closed-loop saturation driver for steady-state
  throughput measurement and for deterministic CI smoke runs.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from .metrics import RequestRecord, summarize

__all__ = ["LoadConfig", "Arrival", "poisson_trace", "make_prompts",
           "serve_trace"]


@dataclasses.dataclass(frozen=True)
class LoadConfig:
    """Offered-load model. Lengths are inclusive [lo, hi] ranges; prompts
    mix a short and a long population (``long_frac`` of requests draw
    from ``prompt_long``) so prefill cost is realistically bimodal."""
    rate: float                                # offered requests/s
    num_requests: int
    prompt_short: tuple = (4, 16)
    prompt_long: tuple = (24, 64)
    long_frac: float = 0.25
    output_lens: tuple = (4, 32)
    deadline: float | None = None              # relative seconds; None = off
    priorities: tuple = (0,)                   # drawn uniformly per request
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class Arrival:
    t: float                     # seconds since trace start
    prompt_len: int
    max_new: int
    deadline: float | None       # relative to submission; None = none
    priority: int


def poisson_trace(cfg: LoadConfig) -> list[Arrival]:
    """The full arrival schedule, deterministic in ``cfg.seed``."""
    if cfg.rate <= 0:
        raise ValueError(f"offered rate must be positive, got {cfg.rate}")
    g = np.random.default_rng(cfg.seed)
    n = cfg.num_requests
    ts = np.cumsum(g.exponential(1.0 / cfg.rate, size=n))
    is_long = g.random(n) < cfg.long_frac
    short = g.integers(cfg.prompt_short[0], cfg.prompt_short[1] + 1, size=n)
    long = g.integers(cfg.prompt_long[0], cfg.prompt_long[1] + 1, size=n)
    plens = np.where(is_long, long, short)
    outs = g.integers(cfg.output_lens[0], cfg.output_lens[1] + 1, size=n)
    prios = g.choice(np.asarray(cfg.priorities), size=n)
    return [Arrival(float(ts[i]), int(plens[i]), int(outs[i]),
                    cfg.deadline, int(prios[i])) for i in range(n)]


def make_prompts(trace, vocab: int, seed: int = 0) -> list[np.ndarray]:
    """One (1, S) int32 prompt per arrival, deterministic in ``seed``."""
    g = np.random.default_rng(seed + 0x5EED)
    return [g.integers(0, vocab, size=(1, a.prompt_len)).astype(np.int32)
            for a in trace]


def serve_trace(sched, trace, prompts, *, realtime: bool = True,
                clock=None, offered_rps: float | None = None):
    """Drive ``sched`` (a ContinuousBatchingEngine) through ``trace``.

    Returns ``(records, summary)`` — per-request ``RequestRecord``s in
    trace order and the ``metrics.summarize`` reduction. TTFT measures
    from the SCHEDULED arrival in realtime mode (queueing counts) and
    from submission in closed-loop mode (no pacing fiction).
    """
    clock = clock or time.perf_counter
    records: dict[int, RequestRecord] = {}
    order: list[int] = []

    def on_token(uid, toks, first):
        if first and uid in records and records[uid].first_token is None:
            records[uid].first_token = clock()

    prev_cb = sched.on_token
    sched.on_token = on_token
    start = clock()
    i = 0
    try:
        while i < len(trace) or sched.busy:
            now = clock()
            # release due arrivals (all of them, in schedule order)
            while i < len(trace) and (not realtime
                                      or start + trace[i].t <= now):
                a = trace[i]
                sched_t = start + a.t if realtime else now
                deadline = None if a.deadline is None else now + a.deadline
                uid = sched.submit(prompts[i], a.max_new,
                                   deadline=deadline, priority=a.priority)
                records[uid] = RequestRecord(
                    uid, scheduled=sched_t, prompt_len=a.prompt_len,
                    max_new=a.max_new, deadline=deadline, submitted=now,
                    reason="pending")
                order.append(uid)
                i += 1
                if not realtime:
                    break       # closed loop: one per iteration, keep
                                # admission interleaved with decode
            if sched.busy:
                for fin in sched.step():
                    r = records.get(fin.uid)
                    if r is None:
                        continue
                    r.finished = clock()
                    r.tokens = len(fin.tokens)
                    r.reason = fin.reason
            elif realtime and i < len(trace):
                # idle until the next arrival is due (bounded nap so a
                # virtual clock driver can still make progress)
                time.sleep(min(max(start + trace[i].t - clock(), 0.0),
                               1e-3))
    finally:
        sched.on_token = prev_cb
    wall = clock() - start
    recs = [records[u] for u in order]
    return recs, summarize(recs, wall, offered_rps=offered_rps)

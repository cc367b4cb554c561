"""Production-traffic serving support (the port's copy of the
reference's ``traffic`` package: numpy and Python, with tensors where the
reference holds device arrays).

The pieces the continuous-batching scheduler is built from, plus the
load model that measures it:

- pool      — SlotPool: free-list admission over preallocated slot state
- admission — AdmissionQueue: priority/deadline ordering, overload shedding
- dispatch  — DispatchQueue: dispatch-ahead (double-buffered) chunk queue
- loadgen   — Poisson arrivals with mixed lengths, deterministic traces
- metrics   — per-request TTFT/TPOT records and the p50/p99 reduction

`repro_torch.serving.scheduler.ContinuousBatchingEngine` composes pool +
admission + dispatch; ``launch.serve --traffic`` drives it with loadgen
and prints the measured latency figures.
"""
from .admission import AdmissionQueue, QueuedRequest
from .dispatch import DispatchQueue, InFlight
from .loadgen import (Arrival, LoadConfig, make_prompts, poisson_trace,
                      serve_trace)
from .metrics import RequestRecord, percentile, summarize
from .pool import SlotInfo, SlotPool

__all__ = ["AdmissionQueue", "QueuedRequest", "DispatchQueue", "InFlight",
           "Arrival", "LoadConfig", "make_prompts", "poisson_trace",
           "serve_trace", "RequestRecord", "percentile", "summarize",
           "SlotInfo", "SlotPool"]

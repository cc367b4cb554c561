"""Serving of the port: the DecodeStep contract, the lockstep engine,
the captured decode loop, sampling and continuous batching.

- runtime   — the DecodeStep protocol, the captured decode loop
- sampling  — on-device greedy / temperature / top-k / top-p sampling
- engine    — ServeEngine: prefill + lockstep batched decode (sharded
              over a mesh for the packed LSTM), cache_shardings
- scheduler — ContinuousBatchingEngine: pooled-slot continuous batching
              with dispatch-ahead, bucketed prefill, deadlines and
              per-token streaming (built on repro_torch.traffic)
"""
from .engine import ServeEngine, cache_shardings
from .runtime import (DecodeStep, conforms, decode_loop, decode_loop_eager,
                      prefill_accepts_length)
from .sampling import (SamplingConfig, sample, sample_dist,
                       sample_from_dist, sample_with_dist)
from .scheduler import (ContinuousBatchingEngine, Request, Finished,
                        TokenEvent)

__all__ = ["ServeEngine", "cache_shardings", "DecodeStep", "conforms", "decode_loop",
           "decode_loop_eager", "prefill_accepts_length", "SamplingConfig",
           "sample", "sample_dist", "sample_from_dist", "sample_with_dist",
           "ContinuousBatchingEngine", "Request", "Finished", "TokenEvent"]

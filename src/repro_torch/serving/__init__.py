"""Serving of the port: lockstep engine, decode loop and sampling."""
from .engine import ServeEngine
from .runtime import (conforms, decode_loop, decode_loop_eager,
                      prefill_accepts_length)
from .sampling import (SamplingConfig, sample, sample_dist,
                       sample_from_dist, sample_with_dist)

__all__ = ["ServeEngine", "conforms", "decode_loop", "decode_loop_eager",
           "prefill_accepts_length",
           "SamplingConfig", "sample", "sample_dist", "sample_from_dist",
           "sample_with_dist"]

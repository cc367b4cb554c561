"""Fixed-point inference quantization of the packed BRDS weights.

  scheme    — QuantScheme number formats (``int8``, ``qM.N``),
              quantize / dequantize, per-row scales
  formats   — RowBalancedSparseQ8 (integer codes + float32 per-row scales
              + the unchanged delta-coded columns) and the registered
              ``row_balanced_q8`` format
  calibrate — QuantConfig (the policy's ``quant=`` rule) → QuantPlan
              (static per-layer activation scales)
"""
from .calibrate import QuantConfig, QuantPlan, calibrate_lstm, default_plan
from .formats import (RowBalancedQ8Format, RowBalancedSparseQ8,
                      abstract_quantize_packed, dequantize_packed,
                      packed_bytes_q, quantize_packed)
from .scheme import (QuantScheme, dequantize, parse_scheme, quantize,
                     row_scales)

__all__ = [
    "QuantScheme", "parse_scheme", "quantize", "dequantize", "row_scales",
    "RowBalancedSparseQ8", "RowBalancedQ8Format", "quantize_packed",
    "dequantize_packed", "abstract_quantize_packed", "packed_bytes_q",
    "QuantConfig", "QuantPlan",
    "calibrate_lstm", "default_plan",
]

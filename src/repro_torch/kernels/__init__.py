"""Kernels of the port: plain PyTorch versions (``ref``) and hand-written
CUDA kernels (``csrc/``) behind the ``ops`` wrappers."""
from .ops import (LAUNCHES, rb_dual_spmv, lstm_gates, brds_lstm_step,
                  fused_brds_lstm_step)
from . import ref

__all__ = ["LAUNCHES", "rb_dual_spmv", "lstm_gates", "brds_lstm_step",
           "fused_brds_lstm_step", "ref"]

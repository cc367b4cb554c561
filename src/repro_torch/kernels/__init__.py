"""Kernels of the port: plain PyTorch versions (``ref``) and hand-written
CUDA kernels (``csrc/``) behind the ``ops`` wrappers.

The single-family ops ``rb_spmv``, ``rb_spmv_q8`` and ``delta_rb_spmv`` and
the attention ops ``flash_attention`` and ``decode_attention`` are reached
as ``ops.<name>``: the package's submodules of those names hold their
kernels."""
from .ops import (LAUNCHES, rb_dual_spmv, lstm_gates, brds_lstm_step,
                  fused_brds_lstm_step, delta_rb_dual_spmv,
                  brds_delta_lstm_step, fused_brds_delta_lstm_step,
                  rb_dual_spmv_q8, delta_rb_dual_spmv_q8, brds_lstm_step_q8,
                  brds_delta_lstm_step_q8, fused_brds_lstm_step_q8,
                  fused_brds_delta_lstm_step_q8, fused_brds_lstm_scan,
                  fused_brds_delta_lstm_scan)
from . import ref

__all__ = ["LAUNCHES", "rb_dual_spmv", "lstm_gates", "brds_lstm_step",
           "fused_brds_lstm_step", "delta_rb_dual_spmv",
           "brds_delta_lstm_step", "fused_brds_delta_lstm_step",
           "rb_dual_spmv_q8", "delta_rb_dual_spmv_q8", "brds_lstm_step_q8",
           "brds_delta_lstm_step_q8", "fused_brds_lstm_step_q8",
           "fused_brds_delta_lstm_step_q8", "fused_brds_lstm_scan",
           "fused_brds_delta_lstm_scan", "ref"]

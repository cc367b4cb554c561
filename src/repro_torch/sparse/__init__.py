"""Sparsity API of the port: backend selection, formats, policy → plan,
and the temporal-delta activation rule."""
from .backend import (BACKENDS, get_default_backend, set_default_backend,
                      use_backend)
from .formats import SparseFormat, get_format, register
from .policy import (Rule, SparsityPolicy, SparsityPlan, lstm_policy,
                     apply_masks, sparsity_report)
from .temporal import (DeltaGateConfig, cap_count, delta_threshold,
                       occupancy_report)

# Importing quant.formats registers "row_balanced_q8" (quant builds on this
# package's registry, so it cannot be imported before it).
from ..quant import formats as _quant_formats  # noqa: E402,F401
from ..quant import QuantConfig  # noqa: E402  (re-export: the policy rule)

__all__ = ["BACKENDS", "get_default_backend", "set_default_backend",
           "use_backend", "SparseFormat", "get_format", "register", "Rule",
           "SparsityPolicy", "SparsityPlan", "lstm_policy", "apply_masks",
           "sparsity_report", "DeltaGateConfig", "cap_count",
           "delta_threshold", "occupancy_report", "QuantConfig"]

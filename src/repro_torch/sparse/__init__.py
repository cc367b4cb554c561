"""Sparsity API of the port: backend selection, formats, policy → plan."""
from .backend import (BACKENDS, get_default_backend, set_default_backend,
                      use_backend)
from .formats import SparseFormat, get_format, register
from .policy import (Rule, SparsityPolicy, SparsityPlan, lstm_policy,
                     apply_masks, sparsity_report)

__all__ = ["BACKENDS", "get_default_backend", "set_default_backend",
           "use_backend", "SparseFormat", "get_format", "register", "Rule",
           "SparsityPolicy", "SparsityPlan", "lstm_policy", "apply_masks",
           "sparsity_report"]

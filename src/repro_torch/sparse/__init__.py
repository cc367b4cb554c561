"""repro_torch.sparse — the one public API for sparsity.

  formats  — SparseFormat registry (row_balanced, bank_balanced, block,
             unstructured; quant adds row_balanced_q8): mask generation,
             packed representation, matvec / dual_matvec kernel dispatch,
             memory accounting.
  policy   — SparsityPolicy (per-weight-family pattern + ratio) compiles
             against a param tree into a SparsityPlan with prune / pack /
             matvec.
  search   — the BRDS Fig.-5 search over SparsityPolicy objects.
  temporal — DeltaGateConfig: Spartus-style activation-delta skipping,
             the policy's activation rule.
  backend  — "cuda" | "ref" | "auto", per call or process-wide.

``apply_masks`` / ``mask_grads`` (and the plan's methods of those names)
hold the masks through masked retraining (``repro_torch.training``)."""
from .backend import (BACKENDS, get_default_backend, set_default_backend,
                      use_backend)
from .formats import (SparseFormat, MaskedDense, register, get_format,
                      available_formats, dual_matvec)
from .policy import (Rule, SparsityPolicy, SparsityPlan, lstm_policy,
                     transformer_policy, classify, apply_masks, mask_grads,
                     sparsity_report)
from .search import (BRDSResult, brds_search, plane_search,
                     execution_time_model)
from .temporal import (DeltaGateConfig, cap_count, delta_threshold,
                       occupancy_report)

# Importing quant.formats registers "row_balanced_q8" (quant builds on this
# package's registry, so it cannot be imported before it).
from ..quant import formats as _quant_formats  # noqa: E402,F401
from ..quant import QuantConfig  # noqa: E402  (re-export: the policy rule)

__all__ = ["BACKENDS", "get_default_backend", "set_default_backend",
           "use_backend", "SparseFormat", "MaskedDense", "register",
           "get_format", "available_formats", "dual_matvec", "Rule",
           "SparsityPolicy", "SparsityPlan", "lstm_policy",
           "transformer_policy", "classify", "apply_masks",
           "mask_grads", "sparsity_report", "BRDSResult", "brds_search",
           "plane_search", "execution_time_model", "DeltaGateConfig",
           "cap_count", "delta_threshold", "occupancy_report", "QuantConfig"]

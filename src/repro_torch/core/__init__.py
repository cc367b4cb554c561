"""repro_torch.core — the paper's contribution: row-balanced dual-ratio
sparsity (masks, packing, the Fig.-5 search) and the accuracy metrics."""
from .sparsity import (keep_count, row_balanced_mask, unstructured_mask,
                       block_mask, bank_balanced_mask, apply_mask,
                       sparsity_of)
from .packing import (RowBalancedSparse, pack, unpack, pack_from_dense,
                      pad_packed)
from .brds import brds_search, BRDSResult, execution_time_model
from . import metrics

__all__ = ["keep_count", "row_balanced_mask", "unstructured_mask",
           "block_mask", "bank_balanced_mask", "apply_mask", "sparsity_of",
           "RowBalancedSparse", "pack", "unpack", "pack_from_dense",
           "pad_packed", "brds_search", "BRDSResult", "execution_time_model",
           "metrics"]

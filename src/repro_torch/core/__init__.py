from .sparsity import keep_count, row_balanced_mask, apply_mask
from .packing import (RowBalancedSparse, pack, unpack, pack_from_dense,
                      pad_packed)

__all__ = ["keep_count", "row_balanced_mask", "apply_mask",
           "RowBalancedSparse", "pack", "unpack", "pack_from_dense",
           "pad_packed"]

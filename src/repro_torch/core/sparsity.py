"""Row-balanced pruning masks (the paper's §3 pattern, Fig. 2e).

Boolean masks with True = keep. A row-balanced mask keeps EXACTLY the same
number of elements in every row. The baseline patterns (unstructured,
block, bank-balanced) are not ported yet.
"""
from __future__ import annotations

import torch

__all__ = ["keep_count", "row_balanced_mask", "apply_mask"]


def keep_count(ncols: int, sparsity: float) -> int:
    """Number of elements kept per row at a given sparsity ratio:
    ``ncols - round(Spar * ncols)``, at least 1."""
    k = ncols - int(round(float(sparsity) * ncols))
    return max(1, min(ncols, k))


def _topk_mask_lastdim(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Mask keeping the k largest entries along the last dim.

    Double stable argsort: ties break by position, and exactly k entries
    survive per row.
    """
    order = torch.argsort(-scores, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    return ranks < k


def row_balanced_mask(w: torch.Tensor, sparsity: float) -> torch.Tensor:
    """Prune the smallest ``sparsity`` fraction of |w| along the last dim
    of every row; every row keeps ``keep_count(ncols, sparsity)``."""
    if w.ndim < 2:
        raise ValueError(f"row_balanced_mask expects ≥2-D weight, got "
                         f"{tuple(w.shape)}")
    k = keep_count(w.shape[-1], sparsity)
    return _topk_mask_lastdim(w.abs(), k)


def apply_mask(w: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, w, torch.zeros_like(w))

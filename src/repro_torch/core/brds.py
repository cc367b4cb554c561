"""DEPRECATED shim — the BRDS Fig.-5 search lives in ``repro_torch.sparse``.

``repro_torch.sparse.brds_search`` walks SparsityPolicy objects
(``policy_at(spar_x, spar_h)`` + ``retrain_fn(params, plan, masks)``).
This module keeps the legacy raw-callback signature
(``prune_fn(params, spar_x, spar_h)`` / ``retrain_fn(params, masks)``),
implemented over the same plane walk.
"""
from __future__ import annotations

import warnings
from typing import Any, Callable

from ..sparse.search import BRDSResult, execution_time_model, plane_search

__all__ = ["BRDSResult", "brds_search", "execution_time_model"]


def brds_search(
    params: Any,
    *,
    overall_sparsity: float,
    prune_fn: Callable,
    retrain_fn: Callable,
    eval_fn: Callable,
    alpha: float = 0.25,
    delta_x: float = 0.05,
    delta_h: float = 0.05,
    max_ratio: float = 0.99,
) -> BRDSResult:
    """Legacy callback-based search. Prefer
    ``repro_torch.sparse.brds_search``."""
    warnings.warn(
        "repro_torch.core.brds_search is deprecated; use "
        "repro_torch.sparse.brds_search with a SparsityPolicy factory "
        "(policy_at=) instead", DeprecationWarning, stacklevel=2)

    def visit(p, sx, sh):
        p, masks = prune_fn(p, sx, sh)
        return retrain_fn(p, masks), None

    return plane_search(params, overall_sparsity=overall_sparsity,
                        visit=visit, eval_fn=eval_fn, alpha=alpha,
                        delta_x=delta_x, delta_h=delta_h,
                        max_ratio=max_ratio)

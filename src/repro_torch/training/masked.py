"""DEPRECATED shim — BRDS masked retraining lives in ``repro_torch.sparse``.

The transformer dual-ratio surface (``brds_masks`` / ``apply_masks`` /
``mask_grads`` / ``brds_pack_params``) is ``sparse.transformer_policy``
compiled into a SparsityPlan:

    plan = transformer_policy(spar_a, spar_b).compile(params)
    pruned, masks = plan.prune(params)
    grads = plan.mask_grads(grads, masks)
    packed, report = plan.pack(pruned, masks)

These wrappers keep the reference's call signatures (and mask dict layout,
{path: bool mask}) with a DeprecationWarning.
"""
from __future__ import annotations

import warnings

from ..sparse.policy import (apply_masks, classify, mask_grads,
                             transformer_policy)
from ..sparse.policy import sparsity_report as _sparsity_report

__all__ = ["brds_masks", "apply_masks", "mask_grads", "brds_pack_params",
           "sparsity_report", "classify"]


def _warn(old: str, new: str):
    warnings.warn(f"repro_torch.training.masked.{old} is deprecated; use "
                  f"repro_torch.sparse.{new}", DeprecationWarning,
                  stacklevel=3)


def brds_masks(params, spar_a: float, spar_b: float) -> dict:
    """Masks for every prunable weight: {path: bool mask}."""
    _warn("brds_masks", "transformer_policy(...).compile(params).masks()")
    return transformer_policy(spar_a, spar_b).compile(params).masks(params)


def brds_pack_params(params, spar_a: float, spar_b: float,
                     abstract: bool = False):
    """Every prunable weight in its packed RowBalancedSparse form (rows =
    output units, cols = fan-in). Returns (new_params, report).
    ``abstract=True``: the dry run's stand-ins (``meta`` tensors) from the
    leaves' shapes and dtypes (``params`` may be ``meta`` tensors)."""
    _warn("brds_pack_params", "transformer_policy(...).compile(params).pack()")
    return transformer_policy(spar_a, spar_b).compile(params).pack(
        params, abstract=abstract)


def sparsity_report(params, masks) -> dict:
    return _sparsity_report(masks)

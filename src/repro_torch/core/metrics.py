"""Accuracy metrics used by the paper's evaluations (the search's eval
callbacks)."""
from __future__ import annotations

import math

import torch

__all__ = ["perplexity", "token_accuracy", "binary_accuracy", "cross_entropy"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token cross-entropy. logits (..., V), labels (...) int; with a
    0/1 ``mask`` (...), the mean over the masked-in positions (an all-zero
    mask gives 0, not a division by zero)."""
    logits = logits.float()
    m = logits.amax(dim=-1).detach()
    logz = m + torch.log(torch.exp(logits - m[..., None]).sum(dim=-1))
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - ll
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1)
    return nll.mean()


def perplexity(mean_nll: float) -> float:
    """PTB metric: exp of the mean per-token negative log likelihood."""
    return math.exp(float(mean_nll))


def token_accuracy(logits, labels, mask=None) -> float:
    hit = (logits.argmax(dim=-1) == labels).float()
    if mask is not None:
        mask = mask.float()
        return float((hit * mask).sum() / torch.clamp_min(mask.sum(), 1))
    return float(hit.mean())


def binary_accuracy(logits, labels) -> float:
    """IMDB-style binary sentiment classification accuracy."""
    pred = (logits[..., 0] > 0).to(labels.dtype)
    return float((pred == labels).float().mean())

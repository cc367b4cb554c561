"""Acceptance rules and accepted-length accounting for speculative decode.

Conventions (one round, batch row dropped): the draft proposed
``d_1..d_k`` with proposal distributions ``q_1..q_k``; the target's verify
produced distributions ``p_0..p_k``, where ``p_{i-1}`` governs the slot
``d_i`` sits in and ``p_k`` is the bonus slot after a full acceptance. The
accepted length a ∈ [0, k] is the length of the accepted draft PREFIX; the
round then commits a+1 tokens (the round-opening token plus the a accepted
proposals) and samples the next token from ``residual_dist``: the
corrected distribution on a rejection, the bonus distribution ``p_k`` on
full acceptance.

Greedy decode uses the exact-match rule; with one-hot greedy distributions
the rejection rule reduces to it, so the same residual serves both and
greedy stays deterministic and lossless.
"""
from __future__ import annotations

import torch

__all__ = ["accept_length", "greedy_accept", "rejection_accept",
           "residual_dist"]


def accept_length(ok):
    """(B, k) per-position accept bools → (B,) int32 accepted-PREFIX
    length: acceptance stops at the first rejection."""
    return torch.cumprod(ok.to(torch.int32), dim=1).sum(
        dim=1, dtype=torch.int32)


def greedy_accept(draft_tokens, target_logits):
    """Exact-match rule: accept ``d_i`` while it equals the target's argmax
    at its slot. ``draft_tokens`` (B, k); ``target_logits`` (B, ≥k, V) raw
    logits or distributions (the argmax is the same)."""
    k = draft_tokens.shape[1]
    tgt = torch.argmax(target_logits[:, :k].float(), dim=-1)
    return accept_length(draft_tokens == tgt.to(draft_tokens.dtype))


def rejection_accept(generator: torch.Generator | None, draft_tokens,
                     p_dists, q_dists):
    """Speculative-sampling rule: accept ``d_i`` while ``u_i <
    p_{i-1}(d_i) / q_i(d_i)`` with u_i ~ U[0, 1) from ``generator``; with
    ``residual_dist`` resampling the emitted tokens are exact samples of
    the target's chain. ``p_dists`` (B, k+1, V), ``q_dists`` (B, k, V),
    both ``sampling.sample_dist`` outputs."""
    B, k = draft_tokens.shape
    idx = draft_tokens.long()[..., None]
    p_tok = torch.gather(p_dists[:, :k], -1, idx)[..., 0]
    q_tok = torch.gather(q_dists, -1, idx)[..., 0]
    u = torch.rand((B, k), generator=generator, device=p_dists.device)
    # u * q < p  ⇔  u < p / q, without dividing by zero
    return accept_length(u * torch.clamp_min(q_tok, 1e-30) < p_tok)


def residual_dist(p_dists, q_dists, accept_len):
    """Next-token distribution at the round's stop slot, (B, V).

    On a rejection at slot a < k: ``norm(max(p_a − q_{a+1}, 0))``, the
    corrected distribution that makes rejection sampling exact. On full
    acceptance (a = k): the bonus distribution ``p_k``. An all-zero
    residual (p ≤ q wherever mass sits) falls back to ``p_a``.
    """
    B, _, V = p_dists.shape
    qz = torch.cat([q_dists, q_dists.new_zeros((B, 1, V))], dim=1)
    a = accept_len.long()[:, None, None].expand(B, 1, V)
    p_a = torch.gather(p_dists, 1, a)[:, 0]
    q_a = torch.gather(qz, 1, a)[:, 0]
    res = torch.clamp_min(p_a - q_a, 0.0)
    z = res.sum(dim=-1, keepdim=True)
    return torch.where(z > 0, res / torch.clamp_min(z, 1e-30), p_a)

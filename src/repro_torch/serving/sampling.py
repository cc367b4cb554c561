"""On-device token sampling for the decode loop.

A ``SamplingConfig`` is a static description of how to turn the
last-position logits into the next token: greedy argmax at temperature 0,
otherwise temperature-scaled categorical, optionally restricted to the
top-k logits and/or the top-p (nucleus) probability mass.

Random draws come from an explicit ``torch.Generator`` on the logits'
device, by the Gumbel-max trick, which needs no host sync. They are not the
reference's ``jax.random`` bits: compare distributions, not draws.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["SamplingConfig", "sample", "sample_dist", "sample_with_dist",
           "sample_from_dist"]

_NEG = -1e30


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """Static sampling parameters.

    temperature: 0 → greedy argmax; >0 → categorical over logits/T.
    top_k:       >0 → restrict sampling to the k largest logits.
    top_p:       in (0, 1) → nucleus sampling: the smallest set of tokens
                 whose probability mass (after temperature and top-k)
                 reaches p; 0 or ≥1 disables. The most likely token is
                 always kept. Composes with top_k (k first).
    eos_id:      ≥0 → sequences stop after emitting this id (the EOS token
                 itself is emitted; later steps emit ``pad_id``).
    pad_id:      filler id emitted by finished sequences.
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 0.0
    eos_id: int = -1
    pad_id: int = 0

    def __post_init__(self):
        if self.top_p < 0.0:
            raise ValueError(f"top_p must be >= 0, got {self.top_p}")

    @property
    def stops(self) -> bool:
        return self.eos_id >= 0


def _filtered(logits, cfg: SamplingConfig):
    """Temperature-scaled, top-k/top-p-masked logits (float32); only for
    temperature > 0."""
    scaled = logits.float() / cfg.temperature
    if cfg.top_k > 0:
        kth = torch.topk(scaled, cfg.top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled < kth, _NEG, scaled)
    if 0.0 < cfg.top_p < 1.0:
        # a token survives iff the mass strictly before it (in descending
        # probability order) is < p: the argmax always survives and ties
        # at the boundary resolve inclusively
        sort = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(sort, dim=-1)
        before = torch.cumsum(probs, dim=-1) - probs
        keep = before < cfg.top_p
        cut = torch.where(keep, sort, torch.inf).amin(dim=-1, keepdim=True)
        scaled = torch.where(scaled < cut, _NEG, scaled)
    return scaled


def _gumbel_argmax(generator: torch.Generator | None, scores):
    """argmax(scores + Gumbel noise): one categorical draw per row."""
    u = torch.rand(scores.shape, generator=generator, device=scores.device)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(scores + gumbel, dim=-1).to(torch.int32)


def sample(generator: torch.Generator | None, logits, cfg: SamplingConfig):
    """logits (B, V) → next-token ids (B,) int32."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits.float(), dim=-1).to(torch.int32)
    return _gumbel_argmax(generator, _filtered(logits, cfg))


def sample_dist(logits, cfg: SamplingConfig):
    """The distribution ``sample`` draws from: logits (..., V) → float32
    probabilities (..., V). Greedy is the one-hot of the argmax."""
    logits = logits.float()
    if cfg.temperature <= 0.0:
        return torch.nn.functional.one_hot(
            torch.argmax(logits, dim=-1), logits.shape[-1]).float()
    return torch.softmax(_filtered(logits, cfg), dim=-1)


def sample_with_dist(generator: torch.Generator | None, logits,
                     cfg: SamplingConfig):
    """``(sample(...), sample_dist(...))`` in one call: next-token ids (...,)
    int32 and the distribution (..., V) they were drawn from. The ids are
    what ``sample`` draws from the same generator state."""
    return sample(generator, logits, cfg), sample_dist(logits, cfg)


def sample_from_dist(generator: torch.Generator | None, dist,
                     cfg: SamplingConfig):
    """Draw ids (...,) int32 from an explicit distribution (..., V), a
    ``sample_dist`` output or the speculative residual: the filtering has
    already happened, so greedy is the argmax and temperature a Gumbel-max
    draw over ``log(max(dist, 1e-30))``."""
    if cfg.temperature <= 0.0:
        return torch.argmax(dist, dim=-1).to(torch.int32)
    return _gumbel_argmax(generator,
                          torch.log(torch.clamp_min(dist.float(), 1e-30)))

"""The decode contract servable models implement, and the generation loop
built on it.

A servable model provides ``cache_defs(batch, max_len)``,
``init_cache(batch, max_len, device)``, ``prefill(params, tokens, max_len,
extra=None[, length=None])`` → (last logits (B, 1, V), cache) and
``decode_step(params, cache, tokens, pos)`` → (logits (B, 1, V), cache).

``decode_loop`` runs sampling, per-sequence EOS / budget / cache-limit
stops and position bookkeeping on the device: the loop body reads nothing
back to the host, so the host only enqueues work.
"""
from __future__ import annotations

import inspect

import torch

from .sampling import SamplingConfig, sample

__all__ = ["conforms", "decode_loop", "prefill_accepts_length"]


def conforms(model) -> bool:
    """Whether ``model`` implements the serving contract."""
    return all(callable(getattr(model, m, None))
               for m in ("cache_defs", "init_cache", "prefill", "decode_step"))


def prefill_accepts_length(model) -> bool:
    """Whether ``model.prefill`` takes the optional ``length`` argument."""
    try:
        return "length" in inspect.signature(model.prefill).parameters
    except (TypeError, ValueError):
        return False


def decode_loop(model, params, cache, logits, pos, generator, steps: int,
                sampling: SamplingConfig, *, done=None, budget=None,
                limit: int | None = None):
    """Generate ``steps`` tokens on the device.

    Parameters
    ----------
    model : a servable model.
    params : dense, pruned or packed params.
    cache : the decode cache from ``prefill``.
    logits : (B, 1, V) last-position logits from prefill.
    pos : scalar next cache position (lockstep) or (B,) per-sequence
        positions (ragged); a finished sequence's position is frozen.
    generator : torch.Generator on the logits' device (temperature > 0).
    steps : tokens to generate.
    sampling : greedy / temperature / top-k / top-p, EOS and pad ids.
    done : optional (B,) bool, sequences that start finished.
    budget : optional (B,) int, per-sequence max tokens to emit.
    limit : optional cache capacity; sequences stop before passing it.

    Returns
    -------
    (tokens (B, steps) int32, state dict with the final cache, logits, pos,
    done and emitted counts).
    """
    B = logits.shape[0]
    dev = logits.device
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev)
    per_seq_pos = pos.ndim == 1
    done = (torch.zeros((B,), dtype=torch.bool, device=dev) if done is None
            else torch.as_tensor(done, dtype=torch.bool, device=dev))
    emitted = torch.zeros((B,), dtype=torch.int32, device=dev)
    pad = torch.tensor(sampling.pad_id, dtype=torch.int32, device=dev)
    toks = []
    for _ in range(steps):
        nxt = sample(generator, logits[:, -1], sampling)
        nxt = torch.where(done, pad, nxt)
        emitted = emitted + (~done).to(torch.int32)
        if sampling.stops:
            done = done | (nxt == sampling.eos_id)
        if budget is not None:
            done = done | (emitted >= budget)
        if limit is not None:
            done = done | (pos + 1 >= limit)
        logits, cache = model.decode_step(params, cache, nxt[:, None], pos)
        # freeze positions of finished sequences (scalar: once all finish)
        frozen = done if per_seq_pos else done.all()
        pos = pos + (~frozen).to(torch.int32)
        toks.append(nxt)
    out = (torch.stack(toks, dim=1) if toks
           else torch.zeros((B, 0), dtype=torch.int32, device=dev))
    return out, dict(cache=cache, logits=logits, pos=pos, done=done,
                     emitted=emitted)

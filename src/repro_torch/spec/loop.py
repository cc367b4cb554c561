"""The speculate → verify → accept round loop.

``spec_decode_loop`` is ``decode_loop``'s speculative sibling, with its
carry discipline (per-sequence done / emitted / pos, EOS, budget and limit
stops, pad emission after done), but the unit of work is a ROUND: the
draft proposes k tokens, the target verifies the block, an acceptance rule
keeps a prefix, and both models roll back to the committed point. Each
active row commits at least one token per round (the round-opening
sample), so the loop ends within ``steps`` rounds.

Where ``decode_loop`` carries the last logits, this loop carries
``probs``: the (B, V) sampling DISTRIBUTION of each row's next token (a
``sampling.sample_dist`` output or the rejection residual). Greedy
distributions are one-hot, so greedy commits exactly the target's argmax
chain: token for token the target-only greedy decode.
"""
from __future__ import annotations

import torch

from ..serving.sampling import SamplingConfig, sample_dist, sample_from_dist
from . import verify as V
from .accept import greedy_accept, rejection_accept, residual_dist

__all__ = ["spec_decode_loop"]


def spec_decode_loop(model, draft, params, dparams, cache, dstate, probs,
                     pos, generator: torch.Generator | None, steps: int,
                     k: int, sampling: SamplingConfig, *, done=None,
                     budget=None, limit: int | None = None):
    """Generate up to ``steps`` tokens per row by speculative rounds.

    The reference's device-side while loop is a host loop of at most
    ``steps`` rounds here. Its condition, whether any row is still active,
    is one host read per round (a device-to-host copy that waits for the
    round's work); everything else stays on the device.

    Parameters (beyond ``decode_loop``'s)
    -------------------------------------
    draft : DraftModel
    dparams / dstate : draft params and per-row recurrent state, primed on
        the same prompt as ``cache``.
    probs : (B, V) float32 distribution of the next token,
        ``sample_dist(prefill_logits[:, -1], sampling)``.
    pos : int or (B,) next cache position; vectorized here, since per-row
        commit counts diverge.
    generator : torch.Generator for the round-opening draws, the draft's
        proposals and the rejection rule's uniforms (temperature > 0).
    k : draft tokens proposed per round; k=0 verifies one token per round,
        plain autoregressive decode.

    Returns
    -------
    (tokens (B, steps) int32, pad-filled after a row finishes; state dict
    with the final cache, dstate, probs, pos, done and emitted, plus per-
    row round accounting ``rounds``, ``drafted`` and ``accepted``:
    acceptance rate = accepted / drafted).
    """
    B, _ = probs.shape
    dev = probs.device
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev)
    if pos.ndim == 0:
        pos = torch.full((B,), int(pos), dtype=torch.int32, device=dev)
    done = (torch.zeros((B,), dtype=torch.bool, device=dev) if done is None
            else torch.as_tensor(done, dtype=torch.bool, device=dev))
    greedy = sampling.temperature <= 0.0
    flags = V.cache_leaf_flags(model)
    pad = torch.tensor(sampling.pad_id, dtype=torch.int32, device=dev)
    out = torch.full((B, steps), sampling.pad_id, dtype=torch.int32,
                     device=dev)
    zeros = torch.zeros((B,), dtype=torch.int32, device=dev)
    rows = torch.arange(B, device=dev)
    emitted = rounds = drafted = accepted = zeros
    for _ in range(steps):
        active = ~done & (emitted < steps)
        if not bool(active.any()):          # the one host read per round
            break
        # round-opening token: the sample the previous round left pending
        nxt = torch.where(done, pad, sample_from_dist(generator, probs,
                                                      sampling))
        d_toks, q_dists, d_states = draft.propose(dparams, dstate, nxt, pos,
                                                  k, generator, sampling)
        block = torch.cat([nxt[:, None], d_toks.to(torch.int32)], dim=1)
        t_logits, cache, t_states = V.verify_chain(model, params, cache,
                                                   block, pos, flags)
        p_dists = sample_dist(t_logits, sampling)
        if k == 0:
            a = zeros
        elif greedy:
            a = greedy_accept(d_toks, t_logits)
        else:
            a = rejection_accept(generator, d_toks, p_dists, q_dists)

        # stepwise emission: decode_loop's stop discipline over the a+1
        # committable tokens (EOS emitted itself, budget checked after the
        # increment, limit = the next write position; ``steps`` caps the
        # output without setting done)
        rd, em, m = done, emitted, zeros
        for j in range(k + 1):
            tok_j = block[:, j]
            can = ~rd & (j <= a) & (em < steps)
            slot = torch.clamp_max(em, steps - 1).long()
            out[rows, slot] = torch.where(can, tok_j, out[rows, slot])
            em = em + can.to(torch.int32)
            m = m + can.to(torch.int32)
            if sampling.stops:
                rd = rd | (can & (tok_j == sampling.eos_id))
            if budget is not None:
                rd = rd | (can & (em >= budget))
            if limit is not None:
                rd = rd | (can & (pos + m >= limit))

        # both models back to each row's committed point
        cache = V.rollback(model, cache, t_states, m, flags)
        dstate = draft.select(dstate, d_states, m)

        # the next round's pending distribution: the residual at the stop
        # slot when the commit ended at the acceptance boundary, the
        # verify distribution after the last committed token otherwise
        # (an early stop); unchanged where nothing moved
        p_stop = residual_dist(p_dists, q_dists, a)
        idx = torch.clamp_min(m - 1, 0)
        p_m = torch.gather(p_dists, 1, idx.long()[:, None, None].expand(
            B, 1, p_dists.shape[-1]))[:, 0]
        base = torch.where((idx == a)[:, None], p_stop, p_m)
        probs = torch.where((m == 0)[:, None], probs, base)

        inc = active.to(torch.int32)
        pos, done, emitted = pos + m, rd, em
        rounds = rounds + inc
        drafted = drafted + k * inc
        accepted = accepted + a * inc
    return out, dict(cache=cache, dstate=dstate, probs=probs, pos=pos,
                     done=done, emitted=emitted, rounds=rounds,
                     drafted=drafted, accepted=accepted)

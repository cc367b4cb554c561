"""The speculate → verify → accept round loop.

``spec_decode_loop`` is ``decode_loop``'s speculative sibling, with its
carry discipline (per-sequence done / emitted / pos, EOS, budget and limit
stops, pad emission after done), but the unit of work is a ROUND: the
draft proposes k tokens, the target verifies the block, an acceptance rule
keeps a prefix, and both models roll back to the committed point. Each
active row commits at least one token per round (the round-opening
sample), so every row is done or has ``steps`` tokens within ``steps``
rounds.

``spec_round`` is one round over a carry of static buffers, in place, with
the row's activity folded into its masks: a row that is done or has its
``steps`` tokens commits nothing, rolls both models back to where they
were, keeps its distribution and counts no round, and its positional cache
writes land past the cache, where they drop; so a round in which no row is
active changes nothing but the generator's state. ``spec_decode_loop``
runs chunks of R rounds as one ``CapturedLoop`` (a CUDA graph on the card)
and reads whether any row is still active once a chunk, where the
reference's device-side while loop reads nothing: the result does not
depend on R.

Where ``decode_loop`` carries the last logits, this loop carries
``probs``: the (B, V) sampling DISTRIBUTION of each row's next token (a
``sampling.sample_dist`` output or the rejection residual). Greedy
distributions are one-hot, so greedy commits exactly the target's argmax
chain: token for token the target-only greedy decode.
"""
from __future__ import annotations

import torch

from ..obs import trace as obs_trace
from ..serving import runtime as R
from ..serving.sampling import SamplingConfig, sample_dist, sample_from_dist
from . import verify as V
from .accept import greedy_accept, rejection_accept, residual_dist

__all__ = ["spec_decode_loop", "spec_round", "ROUNDS_PER_CHUNK"]

ROUNDS_PER_CHUNK = 4     # rounds a captured chunk holds (one host read each)
# where an inactive row's cache writes go: past any cache, where a
# per-row position write drops (``attention.kv_cache_update``)
_PARKED = 1 << 30


def spec_round(model, draft, params, dparams, carry: dict, k: int,
               generator, sampling: SamplingConfig, flags, *, steps: int,
               limit: int | None = None) -> None:
    """One speculative round over ``carry``'s static buffers, in place.

    ``carry``: ``cache`` (target), ``dstate`` (draft), ``probs`` (B, V),
    ``pos`` (B,) int32, ``done`` (B,) bool, ``emitted`` (B,) int32,
    ``tokens`` (B, steps) int32, per-row ``rounds`` / ``drafted`` /
    ``accepted`` (B,) int32 and, optionally, ``budget`` (B,) int32;
    ``flags`` is ``verify.cache_leaf_flags(model)``. A row is active while
    it is not done and has emitted fewer than ``steps`` tokens."""
    c = carry
    cache, dstate, probs, pos, done, emitted = (
        c[key] for key in ("cache", "dstate", "probs", "pos", "done",
                           "emitted"))
    budget = c.get("budget")
    B = probs.shape[0]
    active = ~done & (emitted < steps)
    # round-opening token: the sample the previous round left pending
    nxt = sample_from_dist(generator, probs, sampling).masked_fill(
        done, sampling.pad_id)
    pos_in = pos.masked_fill(~active, _PARKED)
    with obs_trace.span("spec.propose", cat="capture", k=k):
        d_toks, q_dists, d_states = draft.propose(dparams, dstate, nxt,
                                                  pos_in, k, generator,
                                                  sampling)
    block = torch.cat([nxt[:, None], d_toks.to(torch.int32)], dim=1)
    with obs_trace.span("spec.verify", cat="capture", k=k):
        t_logits, cache2, t_states = V.verify_chain(model, params, cache,
                                                    block, pos_in, flags)
    p_dists = sample_dist(t_logits, sampling)
    zeros = torch.zeros_like(emitted)
    if k == 0:
        a = zeros
    elif sampling.temperature <= 0.0:
        a = greedy_accept(d_toks, t_logits)
    else:
        a = rejection_accept(generator, d_toks, p_dists, q_dists)

    # stepwise emission: decode_body's stop discipline over the a+1
    # committable tokens (EOS emitted itself, budget checked after the
    # increment, limit = the next write position; ``steps`` caps the
    # output without setting done)
    out = c["tokens"]
    rows = torch.arange(B, device=pos.device)
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
    with obs_trace.span("spec.rollback", cat="capture"):
        cache3 = V.rollback(model, cache2, t_states, m, flags)
        dstate2 = draft.select(dstate, d_states, m)

    # the next round's pending distribution: the residual at the stop
    # slot when the commit ended at the acceptance boundary, the verify
    # distribution after the last committed token otherwise (an early
    # stop); unchanged where nothing moved
    p_stop = residual_dist(p_dists, q_dists, a)
    idx = torch.clamp_min(m - 1, 0)
    p_m = torch.gather(p_dists, 1, idx.long()[:, None, None].expand(
        B, 1, p_dists.shape[-1]))[:, 0]
    base = torch.where((idx == a)[:, None], p_stop, p_m)

    inc = active.to(torch.int32)
    R.assign(cache, cache3)
    R.assign(dstate, dstate2)
    probs.copy_(torch.where((m == 0)[:, None], probs, base))
    pos.add_(m)
    if rd is not done:
        done.copy_(rd)
    emitted.copy_(em)
    c["rounds"].add_(inc)
    c["drafted"].add_(k * inc)
    c["accepted"].add_(a * inc)


def spec_decode_loop(model, draft, params, dparams, cache, dstate, probs,
                     pos, generator: torch.Generator | None, steps: int,
                     k: int, sampling: SamplingConfig, *, done=None,
                     budget=None, limit: int | None = None,
                     rounds_per_chunk: int = ROUNDS_PER_CHUNK,
                     graphs: R.GraphCache | None = None,
                     clone_state: bool = True):
    """Generate up to ``steps`` tokens per row by speculative rounds.

    Chunks of ``rounds_per_chunk`` rounds run as one ``CapturedLoop`` (a
    CUDA graph on the card, taken from ``graphs`` as ``decode_loop``'s),
    at most ceil(steps / rounds_per_chunk) of them; after each the host
    reads once whether any row is still active.

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
    clone_state : as ``decode_loop``'s.

    Returns
    -------
    (tokens (B, steps) int32, pad-filled after a row finishes; state dict
    with the final cache, dstate, probs, pos, done and emitted, per-row
    round accounting ``rounds``, ``drafted`` and ``accepted`` (acceptance
    rate = accepted / drafted), and ``chunks``, the chunks run, an int).
    """
    B = probs.shape[0]
    dev = probs.device
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev)
    if pos.ndim == 0:
        pos = pos.expand(B).contiguous()
    zeros = torch.zeros((B,), dtype=torch.int32, device=dev)
    inputs = dict(
        cache=cache, dstate=dstate, probs=probs, pos=pos,
        done=(torch.zeros((B,), dtype=torch.bool, device=dev) if done is None
              else torch.as_tensor(done, dtype=torch.bool, device=dev)),
        emitted=zeros, rounds=zeros, drafted=zeros, accepted=zeros,
        tokens=torch.full((B, steps), sampling.pad_id, dtype=torch.int32,
                          device=dev),
        live=torch.zeros((), dtype=torch.bool, device=dev))
    if budget is not None:
        inputs["budget"] = torch.as_tensor(budget, dtype=torch.int32,
                                           device=dev)
    flags = V.cache_leaf_flags(model)
    draws = sampling.temperature > 0.0
    n = max(1, min(rounds_per_chunk, steps))

    def body(gen, rounds):
        def fn(c):
            for _ in range(rounds):
                spec_round(model, draft, params, dparams, c, k, gen,
                           sampling, flags, steps=steps, limit=limit)
            c["live"].copy_((~c["done"] & (c["emitted"] < steps)).any())
        return fn

    if dev.type != "cuda":
        loop = R.CapturedLoop(body(generator, n), R.clone_tree(inputs))
    else:
        graphs = graphs if graphs is not None else R.GraphCache(1)

        def make():
            gen = torch.Generator(dev) if draws else None
            return R.CapturedLoop(body(gen, n),
                                  graphs.static_carry("spec", inputs),
                                  warmup=body(gen, 1), generator=gen,
                                  keep=(model, draft, params, dparams))

        key = ("spec", R.get_default_backend(), id(model), id(draft),
               id(params), id(dparams), B,
               steps, k, n, sampling, limit, budget is not None,
               tuple((tuple(x.shape), x.dtype) for x in R.leaves(inputs)),
               dev)
        loop = graphs.loop(key, make)
        R.assign(loop.carry, inputs)
        if draws:
            R.transplant(generator, loop.generator)
    carry = loop.carry
    chunks = 0
    for _ in range(-(-steps // n) if steps else 0):
        loop.run()
        chunks += 1
        if not bool(carry["live"]):          # the one host read a chunk
            break
    if dev.type == "cuda" and draws:
        R.transplant(loop.generator, generator)
    state = {key: carry[key] for key in ("cache", "dstate", "probs", "pos",
                                         "done", "emitted", "rounds",
                                         "drafted", "accepted")}
    toks = carry["tokens"]
    if dev.type == "cuda":
        toks = toks.clone()
        if clone_state:
            state = R.clone_tree(state)
    return toks, dict(state, chunks=chunks)

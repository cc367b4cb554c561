"""k-token target verify: the decode step over a (B, k) token block.

``verify_chain`` scores a block of k tokens by running the model's own
``decode_step`` once per token, the same ops the target-only decode loop
runs, head included, so each position's logits are bitwise what
sequential decoding produces (greedy losslessness rides on this; one head
matmul over B·k rows could take another GEMM kernel and other bits), and
k=1 is exactly one decode step.

Rollback after partial acceptance splits the decode cache by leaf kind,
read off the logical axes of ``cache_defs``:

- *positional* leaves (a ``cache_seq`` axis: KV caches, an int8 cache's
  ``k_scale`` / ``v_scale``, an encoder-decoder's cross memory) roll back
  by position rewind alone, the rejected tail left dead in the buffers;
- *state* leaves (everything else: the LSTM's (c, h) and the delta
  reference state) are O(1) per step, so the chain checkpoints them per
  verified token and ``rollback`` restores each row's checkpoint at its
  accepted length.

Leaves are taken in the reference's flatten order: dict keys sorted,
lists in order.
"""
from __future__ import annotations

import torch

from ..serving.runtime import leaves, unflatten

__all__ = ["cache_leaf_flags", "state_leaves", "verify_chain", "rollback"]


def cache_leaf_flags(model):
    """Per-cache-leaf (positional?, batch axis) lists in ``leaves`` order,
    read from the logical axes of ``model.cache_defs``: a leaf is
    positional iff its axes include ``cache_seq``."""
    defs = leaves(model.cache_defs(2, 4))    # axes don't depend on sizes
    return ([("cache_seq" in d.axes) for d in defs],
            [d.axes.index("batch") for d in defs])


def state_leaves(model, cache, flags=None) -> tuple:
    """The non-positional (recurrent-state) cache leaves, ``leaves``
    order; ``flags`` is ``cache_leaf_flags(model)`` where the caller
    holds it."""
    positional, _ = flags or cache_leaf_flags(model)
    return tuple(x for x, p in zip(leaves(cache), positional) if not p)


def stack_states(pre, steps) -> tuple:
    """Per-leaf checkpoints with leading axis len(steps) + 1: index m is
    the state after m tokens (0: ``pre``)."""
    return tuple(torch.stack([p, *(s[i].to(p.dtype) for s in steps)])
                 for i, p in enumerate(pre))


def verify_chain(model, params, cache, tokens, pos, flags=None):
    """Score a (B, T) token block, one ``decode_step`` per token (token j
    at cache position ``pos + j``; ``pos`` an int or (B,); ``flags`` as
    in ``state_leaves``). Returns

    - ``logits`` (B, T, V) float32: position j conditions on tokens
      ``[:j]`` of the block, i.e. it is the distribution of the token
      AFTER ``tokens[:, j]``;
    - ``cache``: the post-block cache;
    - ``states``: per-state-leaf checkpoints with leading axis T+1 (index
      m: the state after m block tokens), ready for ``rollback``.
    """
    flags = flags or cache_leaf_flags(model)
    positional, _ = flags
    pre = state_leaves(model, cache, flags)
    logits, steps = [], []
    for j in range(tokens.shape[1]):
        lg, cache = model.decode_step(params, cache, tokens[:, j:j + 1],
                                      pos + j)
        logits.append(lg[:, 0].float())
        steps.append([x for x, p in zip(leaves(cache), positional)
                      if not p])
    return torch.stack(logits, dim=1), cache, stack_states(pre, steps)


def rollback(model, cache, states, commit, flags=None):
    """Roll a post-verify cache back to ``commit`` (B,) accepted tokens.
    Positional leaves keep their buffers (the caller rewinds ``pos``);
    state leaves take each row's checkpoint at its ``commit`` index (0:
    the pre-block state). ``flags`` as in ``state_leaves``."""
    positional, batch_axes = flags or cache_leaf_flags(model)
    commit = commit.long()
    rows = torch.arange(commit.shape[0], device=commit.device)
    out, si = [], 0
    for leaf, p, ax in zip(leaves(cache), positional, batch_axes):
        if p:
            out.append(leaf)
            continue
        s = torch.movedim(states[si], ax + 1, 1)       # (T+1, B, ...)
        out.append(torch.movedim(s[commit, rows], 0, ax))
        si += 1
    return unflatten(cache, out)

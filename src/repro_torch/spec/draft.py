"""DraftModel: a BRDS-packed recurrent model adapted as speculative draft.

Wraps a servable model whose decode cache is pure O(1) recurrent state (no
``cache_seq`` axis in its ``cache_defs``): the paper's LSTM in every
serving variant (dense, packed, temporal-delta, quantized, fused or
chained). Positional-cache models are rejected: a draft checkpoints and
restores its whole state every round, which is cheap only for recurrent
state.

The three draft-side operations of a speculative round:

- ``prefill`` primes the state on the prompt. Packed float LSTM drafts run
  exact-length prompts through the multi-token ``fused_brds_lstm_scan``
  kernel, one launch per layer for the whole prompt; each of its steps is
  bitwise the fused single-step kernel's, so the state equals what the
  model's own prefill gives.
- ``propose`` runs the k-token proposal chain (k+1 decode steps) and
  stacks a state checkpoint per consumed token.
- ``select`` is the rollback: each row's checkpoint at its committed-token
  count after acceptance.
"""
from __future__ import annotations

import torch

from ..models import layers as L
from ..serving import runtime
from ..serving.sampling import sample_dist, sample_from_dist
from . import verify

__all__ = ["DraftModel"]


class DraftModel:
    """Speculative-draft adapter around a recurrent servable model.

    Parameters
    ----------
    model : a servable model whose cache is pure recurrent state.
    params : dense, packed, delta-wired or quantized draft params;
        ``decode_step`` dispatches on them, so every BRDS serving variant
        drafts through its own kernels.
    scan_prefill : bool, optional
        Force (True) or disable (False) the scan-kernel prefill; None
        enables it for packed float LSTM params on exact-length prompts
        of up to 64 tokens.
    """

    def __init__(self, model, params, *, scan_prefill=None):
        if not runtime.conforms(model):
            raise TypeError(
                f"{type(model).__name__} does not implement the serving "
                "contract (cache_defs / init_cache / prefill / decode_step)")
        self.flags = verify.cache_leaf_flags(model)
        if any(self.flags[0]):
            raise TypeError(
                f"{type(model).__name__} keeps a positional (cache_seq) "
                "decode cache — a speculative draft must carry O(1) "
                "recurrent state so each round can checkpoint/restore it "
                "(use the LSTM family)")
        self.model = model
        self.params = params
        self.scan_prefill = scan_prefill

    # ---------------------------------------------------------- prefill
    def prefill(self, params, tokens, max_len: int, extra=None, length=None):
        """Prime the draft state on the prompt → (logits (B, 1, V), state),
        as ``model.prefill`` (``length`` where the model takes it), with
        the scan-kernel path where it applies."""
        if self._can_scan_prefill(params, tokens, length):
            return self._scan_prefill_lstm(params, tokens)
        if length is not None:
            return self.model.prefill(params, tokens, max_len, extra=extra,
                                      length=length)
        return self.model.prefill(params, tokens, max_len, extra=extra)

    def _can_scan_prefill(self, params, tokens, length) -> bool:
        if self.scan_prefill is False or length is not None:
            return False
        m = self.model
        if not (hasattr(m, "is_packed") and hasattr(m, "cfg")):
            return False
        if (getattr(m, "delta", None) is not None
                or getattr(m, "quant", None) is not None
                or getattr(m, "mesh", None) is not None):
            return False
        if not getattr(m.cfg, "vocab_size", 0) or tokens.ndim != 2:
            return False
        try:
            packed = m.is_packed(params) and not m.is_quantized(params)
        except (KeyError, IndexError, TypeError):
            return False
        if not packed:
            return False
        # the reference's rule: prompts of up to 64 tokens unless forced
        return self.scan_prefill is True or tokens.shape[1] <= 64

    def _scan_prefill_lstm(self, params, tokens):
        """``fused_brds_lstm_scan`` over the whole prompt, layer by layer:
        one launch per layer."""
        from ..kernels import ops as K
        m, cfg = self.model, self.model.cfg
        B = tokens.shape[0]
        xs = L.embed_apply(params["embed"], tokens).to(
            cfg.dtype).transpose(0, 1).contiguous()        # (T, B, X)
        layers = []
        for lp in params["layers"]:
            zeros = torch.zeros((B, cfg.hidden), dtype=cfg.dtype,
                                device=xs.device)
            hs, c_t = K.fused_brds_lstm_scan(lp["w_x"], xs, lp["w_h"], zeros,
                                             lp["b"], zeros,
                                             pwl=cfg.pwl_activations)
            xs = hs.to(cfg.dtype)
            layers.append({"c": c_t.to(cfg.dtype), "h": xs[-1]})
        return m._head_logits(params, xs[-1]), {"layers": layers}

    # ---------------------------------------------------------- propose
    def propose(self, params, state, nxt, pos, k: int,
                generator: torch.Generator | None, cfg):
        """The k-token proposal chain with rollback checkpoints.

        Runs k+1 draft steps: step j consumes token j of ``[nxt,
        d_1..d_k]`` (``nxt`` is the round's committed opening token) and
        draws d_{j+1} from the draft's distribution under ``cfg``.
        Returns

        - ``tokens`` (B, k) int32: the proposals d_1..d_k;
        - ``qdists`` (B, k, V): their proposal distributions;
        - ``states``: per-leaf checkpoints with leading axis k+2, index m
          the draft state after m tokens of ``[nxt, d_1..d_k]`` (0: the
          pre-round state), for ``select``.
        """
        st, tok = state, nxt
        toks, qs, steps = [], [], []
        for j in range(k + 1):
            logits, st = self.model.decode_step(params, st, tok[:, None],
                                                pos + j)
            q = sample_dist(logits[:, -1], cfg)
            tok = sample_from_dist(generator, q, cfg)
            toks.append(tok)
            qs.append(q)
            steps.append(verify.leaves(st))
        states = verify.stack_states(verify.leaves(state), steps)
        if k == 0:
            B, V = nxt.shape[0], qs[0].shape[-1]
            return nxt.new_zeros((B, 0)), qs[0].new_zeros((B, 0, V)), states
        return torch.stack(toks[:k], dim=1), torch.stack(qs[:k], dim=1), states

    # ----------------------------------------------------------- rollback
    def select(self, state_template, states, commit):
        """Checkpoint/restore rollback: the draft state after ``commit``
        (B,) tokens of the round's block committed; ``state_template`` is
        any state of the right structure (e.g. the pre-round one)."""
        return verify.rollback(self.model, state_template, states, commit,
                               self.flags)

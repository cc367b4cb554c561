"""The paper's LSTM (eq. 1–2) with first-class BRDS sparsity.

Gate layout: rows grouped by gate [f; i; g; o], each H rows, so
W_x ∈ R^{4H×X} and W_h ∈ R^{4H×H}. Dense params step through a plain
matmul; packed row-balanced params step through the BRDS datapath
(``kernels.ops``): the fused single-launch kernel by default, or the
chained rb_dual_spmv → lstm_gates pair with ``fused=False``.

Temporal-delta serving (``delta``), quantized packing (``quant``) and
sharded decode (``mesh``) are not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import layers as L
from ..core.packing import RowBalancedSparse, pad_packed
from ..device import resolve_device
from ..kernels import ops as K
from ..kernels.ref import lstm_cell_ref
from ..sparse import get_format, lstm_policy


@dataclasses.dataclass(frozen=True)
class LSTMConfig:
    name: str
    input_size: int            # X
    hidden: int                # H
    num_layers: int = 1
    vocab_size: int = 0        # >0 → language model (embed + head)
    num_classes: int = 0       # >0 → sequence classifier / framewise
    framewise: bool = False    # per-step classification (TIMIT-style)
    dtype: torch.dtype = torch.float32
    pwl_activations: bool = False   # paper's piecewise-linear σ/tanh


def _full_fp32_matmuls() -> None:
    # The reference computes the head and the dense step in full float32;
    # TF32 keeps about three decimal digits, so the port turns it off for
    # matmuls and for cuDNN explicitly rather than rely on the defaults.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class LSTMModel:
    """The paper's LSTM behind the serving stack.

    ``fused``: True (the default) steps every packed layer through the
    fused single-launch kernel; False takes the chained per-kernel path
    (two launches per layer-step).
    """

    supports_packed_decode = True

    def __init__(self, cfg: LSTMConfig, delta=None, quant=None, mesh=None,
                 fused: bool = True):
        for name, v in (("delta", delta), ("quant", quant), ("mesh", mesh)):
            if v is not None:
                raise NotImplementedError(f"LSTMModel({name}=...) is not "
                                          "ported yet")
        _full_fp32_matmuls()
        self.cfg = cfg
        self.fused = fused

    # ------------------------------------------------------------- params
    def param_defs(self) -> dict:
        cfg = self.cfg
        dt = cfg.dtype
        defs: dict = {"layers": []}
        for i in range(cfg.num_layers):
            x_in = cfg.input_size if i == 0 else cfg.hidden
            defs["layers"].append({
                "w_x": L.PSpec((4 * cfg.hidden, x_in), dtype=dt),
                "w_h": L.PSpec((4 * cfg.hidden, cfg.hidden), dtype=dt),
                "b": L.PSpec((4 * cfg.hidden,), init="zeros", dtype=dt),
            })
        if cfg.vocab_size:
            defs["embed"] = {"table": L.PSpec((cfg.vocab_size, cfg.input_size),
                                              scale=1.0, dtype=dt)}
            defs["head"] = {"w": L.PSpec((cfg.hidden, cfg.vocab_size),
                                         dtype=dt)}
        if cfg.num_classes:
            defs["head"] = {"w": L.PSpec((cfg.hidden, cfg.num_classes),
                                         dtype=dt)}
        return defs

    def init(self, generator: torch.Generator | None = None, device=None):
        """Random params from ``generator`` (a seeded CPU generator; seed 0
        when None) on ``device`` (default ``cuda``; raises without a card
        unless ``device="cpu"`` is given)."""
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        return L.init_params(self.param_defs(), generator, device)

    def param_count(self) -> int:
        return L.count_params(self.param_defs())

    # ------------------------------------------------------------- BRDS
    def prune(self, params, spar_x: float, spar_h: float):
        """Row-balanced dual-ratio prune of every layer. Returns
        (pruned_params, masks) with masks {path: bool mask}."""
        return lstm_policy(spar_x, spar_h).compile(params).prune(params)

    def pack(self, params, masks: dict | None = None):
        """Pack pruned layers into per-layer ``{"sx", "sh", "b"}`` with the
        rows padded once to the kernel block (``pad_packed``). ``masks``
        from ``prune`` keeps surviving weights that are exactly zero; with
        None the survivors are re-selected per row by magnitude."""
        fmt = get_format("row_balanced")
        packed = []
        for i, lp in enumerate(params["layers"]):
            entry = {"b": lp["b"]}
            for key, out in (("w_x", "sx"), ("w_h", "sh")):
                m = (masks or {}).get(f"layers/{i}/{key}")
                if m is None:
                    m = _survivor_mask(lp[key])
                entry[out] = pad_packed(fmt.pack(lp[key], m))
            packed.append(entry)
        return packed

    @staticmethod
    def pad_packed_params(packed, block_rows: int = 256):
        """Pad every packed matrix's rows to the kernel-block multiple once,
        so no step re-pads the weight stream. Accepts ``pack``'s per-layer
        list or a ``SparsityPlan.pack``'d tree; dense leaves pass."""
        def _pad(s):
            return (pad_packed(s, block_rows)
                    if isinstance(s, RowBalancedSparse) else s)
        if isinstance(packed, dict) and "layers" in packed:
            return {**packed, "layers": [
                {**lp, "w_x": _pad(lp["w_x"]), "w_h": _pad(lp["w_h"])}
                for lp in packed["layers"]]}
        return [{**lp, "sx": _pad(lp["sx"]), "sh": _pad(lp["sh"])}
                for lp in packed]

    @staticmethod
    def is_packed(params) -> bool:
        return isinstance(params["layers"][0]["w_x"], RowBalancedSparse)

    # ------------------------------------------------------------- core
    @staticmethod
    def _cell(z, c_prev, *, pwl=False):
        """z (B, 4H) grouped [f; i; g; o] → (c, h)."""
        H = z.shape[-1] // 4
        return lstm_cell_ref(z[..., :H], z[..., H:2 * H], z[..., 2 * H:3 * H],
                             z[..., 3 * H:], c_prev, pwl=pwl)

    def init_state(self, batch: int, device):
        cfg = self.cfg
        return [(torch.zeros((batch, cfg.hidden), dtype=cfg.dtype,
                             device=device),
                 torch.zeros((batch, cfg.hidden), dtype=cfg.dtype,
                             device=device))
                for _ in range(cfg.num_layers)]

    def cache_defs(self, batch: int, max_len: int) -> dict:
        """Decode-cache declaration: (c, h) per layer. ``max_len`` is part
        of the serving contract but unused — the state is O(1)."""
        cfg = self.cfg
        return {"layers": [
            {"c": L.PSpec((batch, cfg.hidden), init="zeros", dtype=cfg.dtype),
             "h": L.PSpec((batch, cfg.hidden), init="zeros", dtype=cfg.dtype)}
            for _ in range(cfg.num_layers)]}

    def init_cache(self, batch: int, max_len: int, device):
        return L.init_params(self.cache_defs(batch, max_len), None,
                             torch.device(device))

    def _step(self, params, x_t, state):
        """One time step, packed or dense by param type. state/new_state:
        list of (c, h); returns (h_last, new_state) in cfg.dtype."""
        cfg = self.cfg
        packed = self.is_packed(params)
        step = K.fused_brds_lstm_step if self.fused else K.brds_lstm_step
        new_state = []
        inp = x_t
        for lp, (c, h) in zip(params["layers"], state):
            if packed:
                c, h = step(lp["w_x"], inp, lp["w_h"], h, lp["b"], c,
                            pwl=cfg.pwl_activations)
            else:
                z = (inp @ lp["w_x"].T + h @ lp["w_h"].T
                     + lp["b"][None, :]).float()
                c, h = self._cell(z, c, pwl=cfg.pwl_activations)
            c, h = c.to(cfg.dtype), h.to(cfg.dtype)
            new_state.append((c, h))
            inp = h
        return inp, new_state

    def _head_logits(self, params, h):
        """h (B, H) → logits (B, 1, V or C) float32."""
        return (h.float() @ params["head"]["w"].float())[:, None]

    def _embed_step(self, params, tokens):
        """tokens (B, 1) ids (LM) or (B, 1, X) features → x_t (B, X)."""
        if self.cfg.vocab_size:
            return L.embed_apply(params["embed"], tokens[:, 0])
        return tokens[:, 0].to(self.cfg.dtype).contiguous()

    def _inputs(self, params, tokens):
        """(B, S) ids or (B, S, X) frames → time-major (S, B, X)."""
        if self.cfg.vocab_size:
            x = L.embed_apply(params["embed"], tokens)
        else:
            x = tokens.to(self.cfg.dtype)
        return x.transpose(0, 1).contiguous()

    def score(self, params, inputs, labels=None):
        """Teacher-forced mean NLL through the serving step path (the exact
        per-token computation decode runs): next-token NLL over positions
        1..T-1 for a language model, per-step NLL against ``labels`` for
        a framewise classifier."""
        cfg = self.cfg
        if labels is None:
            if not cfg.vocab_size:
                raise ValueError("framewise score needs labels")
            labels = inputs
        xs = self._inputs(params, inputs)
        state = self.init_state(xs.shape[1], xs.device)
        hs = []
        for x_t in xs:
            h, state = self._step(params, x_t, state)
            hs.append(h)
        logits = self._head_logits(params, torch.stack(hs, 1).flatten(0, 1))
        logits = logits.reshape(xs.shape[1], xs.shape[0], -1)
        if cfg.vocab_size:
            logits, labels = logits[:, :-1], labels[:, 1:]
        return torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long())

    # ------------------------------------------------------------- serving
    def prefill(self, params, tokens, max_len: int, extra=None, length=None):
        """Process a full prompt and build the decode cache.

        ``length`` (an int or (B,) int tensor) gives the true prompt
        lengths when ``tokens`` is right-padded: steps at t ≥ length
        compute and discard (each sequence's state is frozen), so the
        cache and last-valid logits are what the unpadded prompt gives.
        Every prefill runs this masked body, as the reference does.

        Returns (logits at the last valid position (B, 1, V), cache).
        """
        cfg = self.cfg
        xs = self._inputs(params, tokens)
        S, B = xs.shape[0], xs.shape[1]
        dev = xs.device
        if length is None:
            length = S
        length = torch.as_tensor(length, dtype=torch.int32, device=dev)
        state = self.init_state(B, dev)
        h_last = torch.zeros((B, cfg.hidden), dtype=cfg.dtype, device=dev)
        for t in range(S):
            h, st2 = self._step(params, xs[t], state)
            keep = torch.broadcast_to(t < length, (B,))[:, None]
            state = [(torch.where(keep, c2, c), torch.where(keep, h2, h0))
                     for (c2, h2), (c, h0) in zip(st2, state)]
            h_last = torch.where(keep, h, h_last)
        logits = self._head_logits(params, h_last)
        return logits, {"layers": [{"c": c, "h": h} for c, h in state]}

    def decode_step(self, params, cache, tokens, pos):
        """One decode step over the cache. ``pos`` is accepted per the
        serving contract but unused (the recurrent cache has no positions).
        Returns (logits (B, 1, V), cache)."""
        x_t = self._embed_step(params, tokens)
        state = [(lp["c"], lp["h"]) for lp in cache["layers"]]
        h, new_state = self._step(params, x_t, state)
        cache = {"layers": [{"c": c, "h": h} for c, h in new_state]}
        return self._head_logits(params, h), cache


def _survivor_mask(w: torch.Tensor) -> torch.Tensor:
    """Row-balanced keep-mask for an already-pruned dense weight: per-row
    magnitude top-K at the maximum per-row non-zero count."""
    k = int((w != 0).sum(dim=1).max()) if w.numel() else 0
    order = torch.argsort(-w.abs(), dim=1, stable=True)[:, :k]
    return torch.zeros(w.shape, dtype=torch.bool,
                       device=w.device).scatter_(1, order, True)


def params_from_numpy(tree, device) -> dict:
    """The reference's dense param tree as numpy arrays
    (``{"layers": [{"w_x", "w_h", "b"}], "embed": {"table"},
    "head": {"w"}}``) → the port's tree of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    return torch.tensor(np.asarray(tree), device=device)


def packed_from_numpy(values, deltas, ncols: int, pad: int = 0,
                      block_rows: int | None = None,
                      device="cpu") -> RowBalancedSparse:
    """A ``RowBalancedSparse`` from the reference's packed arrays, so the
    port's kernels run on the very packing the reference produced."""
    return RowBalancedSparse(
        values=torch.tensor(np.asarray(values), device=device),
        deltas=torch.tensor(np.asarray(deltas), device=device),
        ncols=int(ncols), pad=int(pad), block_rows=block_rows)


# Paper benchmark configs (§5.1): TIMIT X=153 H=1024; PTB large 1500/1500;
# IMDB binary classifier.
LSTM_CONFIGS = {
    "lstm_timit": LSTMConfig("lstm_timit", input_size=153, hidden=1024,
                             num_classes=61, framewise=True),
    "lstm_ptb": LSTMConfig("lstm_ptb", input_size=1500, hidden=1500,
                           vocab_size=10000),
    "lstm_imdb": LSTMConfig("lstm_imdb", input_size=128, hidden=512,
                            vocab_size=0, num_classes=2),
}

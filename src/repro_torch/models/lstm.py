"""The paper's LSTM (eq. 1–2) with first-class BRDS sparsity.

Gate layout: rows grouped by gate [f; i; g; o], each H rows, so
W_x ∈ R^{4H×X} and W_h ∈ R^{4H×H}. Dense params step through a plain
matmul; packed row-balanced params step through the BRDS datapath
(``kernels.ops``): the fused single-launch kernel by default, or the
chained rb_dual_spmv → lstm_gates pair with ``fused=False``. Quantized
packings (``RowBalancedSparseQ8``) step through the q8 kernels, and a
``delta`` rule through the temporal-delta ones.

Training (``features`` / ``forward`` / ``loss``) runs the dense layers in
plain PyTorch under autograd; the kernels have no backward and refuse an
operand that requires grad. Under a ``mesh``, on params laid out by
``training.param_shardings`` (DTensors), it runs tensor-parallel
(``dist.tensor_parallel``): each rank's gate rows, vocabulary slice of the
embedding and head columns, the gate preactivations gathered each step.

Under a ``mesh`` packed decode is sharded over the mesh's ranks
(``repro_torch.dist``): each rank steps its gate-aligned block of the
packed rows through the chained kernels and all-gathers h, one collective
a layer-step.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import layers as L
from ..core import sparsity as S
from ..core.metrics import cross_entropy
from ..core.packing import RowBalancedSparse, pad_packed
from ..device import resolve_device
from ..dist.tensor_parallel import TensorParallel
from ..kernels import ops as K
from ..kernels.ref import lstm_cell_ref
from ..quant import (QuantPlan, RowBalancedSparseQ8, parse_scheme,
                     quantize_packed)
from ..sparse import MaskedDense, get_format, lstm_policy
from ..sparse import mask_grads as _sparse_mask_grads
from ..sparse.temporal import delta_threshold

_PACKED = (RowBalancedSparse, RowBalancedSparseQ8)


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

    ``delta`` (a ``DeltaGateConfig`` or None) switches serving to
    Spartus-style temporal sparsity: the decode cache grows per-layer
    reference states (x_ref, h_ref), a float32 partial-sum memory m and
    fired-column counters (nx, nh), and prefill / decode step through
    ``_delta_step``.

    ``quant`` (a ``QuantPlan`` or None) carries the calibrated per-layer
    activation scales for quantized packed params; without a plan they
    still serve, with dynamic max-abs activation scales.

    With both ``delta`` and ``quant``, packed params step through the
    quantized temporal-delta kernels, fused or chained as ``fused`` says.

    ``mesh`` (a DeviceMesh with a ``model`` axis, or None) switches packed
    decode to the sharded path (``repro_torch.dist``): params must be
    ``partition_lstm_params``' gate-aligned row blocks, the cache holds
    this rank's slice of c (and of the delta path's m) beside the
    replicated h, and each layer-step's one collective is the all-gather
    of h. The batch the model is given is the rank's own rows (the engine
    splits a batch over ``data``). Sharded decode always chains (``fused``
    is ignored): the all-gather needs the boundary between the dual SpMV
    and the cell. Composes with ``delta`` and ``quant``.
    """

    supports_packed_decode = True

    def __init__(self, cfg: LSTMConfig, delta=None, quant=None, mesh=None,
                 fused: bool = True):
        _full_fp32_matmuls()
        self.cfg = cfg
        self.delta = delta
        self.quant = quant
        self.mesh = mesh
        self.fused = fused

    def _copy(self, **kw) -> "LSTMModel":
        args = dict(delta=self.delta, quant=self.quant, mesh=self.mesh,
                    fused=self.fused)
        return LSTMModel(self.cfg, **{**args, **kw})

    def with_delta(self, delta) -> "LSTMModel":
        """Copy of this model serving through the temporal-delta path
        (``delta``: a DeltaGateConfig, or None to disable)."""
        return self._copy(delta=delta)

    def with_quant(self, quant) -> "LSTMModel":
        """Copy of this model carrying a quantization plan (``quant``: a
        QuantPlan, or None to disable)."""
        return self._copy(quant=quant)

    def with_mesh(self, mesh) -> "LSTMModel":
        """Copy of this model decoding through the sharded packed path
        (``mesh``: a DeviceMesh with a ``model`` axis, served
        ``repro_torch.dist.partition_lstm_params``' layout, or None)."""
        return self._copy(mesh=mesh)

    def with_fused(self, fused: bool) -> "LSTMModel":
        """Copy of this model with the fused (True) or chained (False)
        packed step."""
        return self._copy(fused=fused)

    @property
    def _use_fused(self) -> bool:
        """The fused single-launch kernels on this step? Sharded decode
        needs the chained kernels' boundary for its collective."""
        return self.fused and self.mesh is None

    @property
    def _shards(self) -> int:
        """Ranks on the mesh's ``model`` axis (1 without a mesh)."""
        if self.mesh is None:
            return 1
        from ..dist.partition import model_axis_size
        return model_axis_size(self.mesh)

    # ------------------------------------------------------------- params
    def param_defs(self) -> dict:
        cfg = self.cfg
        dt = cfg.dtype
        defs: dict = {"layers": []}
        for i in range(cfg.num_layers):
            x_in = cfg.input_size if i == 0 else cfg.hidden
            defs["layers"].append({
                "w_x": L.PSpec((4 * cfg.hidden, x_in), dtype=dt,
                               axes=("lstm_gates", "embed")),
                "w_h": L.PSpec((4 * cfg.hidden, cfg.hidden), dtype=dt,
                               axes=("lstm_gates", "lstm_hidden")),
                "b": L.PSpec((4 * cfg.hidden,), init="zeros", dtype=dt,
                             axes=("lstm_gates",)),
            })
        if cfg.vocab_size:
            defs["embed"] = {"table": L.PSpec((cfg.vocab_size, cfg.input_size),
                                              scale=1.0, dtype=dt,
                                              axes=("vocab", "embed"))}
            defs["head"] = {"w": L.PSpec((cfg.hidden, cfg.vocab_size),
                                         dtype=dt, axes=("embed", "vocab"))}
        if cfg.num_classes:
            defs["head"] = {"w": L.PSpec((cfg.hidden, cfg.num_classes),
                                         dtype=dt, axes=("embed", None))}
        return defs

    def param_axes(self):
        """Each param's logical axes (the sharding rules' names)."""
        return L.param_axes(self.param_defs())

    def init(self, generator: torch.Generator | None = None, device=None):
        """Random params from ``generator`` (a seeded CPU generator; seed 0
        when None) on ``device`` (default ``cuda``; raises without a card
        unless ``device="cpu"`` is given)."""
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        return L.init_params(self.param_defs(), generator, device)

    def abstract_params(self, device="meta"):
        """The params' stand-ins (``layers.abstract_params``): their shapes
        and dtypes, no data."""
        return L.abstract_params(self.param_defs(), device)

    def param_count(self) -> int:
        return L.count_params(self.param_defs())

    # ------------------------------------------------------------- BRDS
    def prune(self, params, spar_x: float, spar_h: float):
        """Row-balanced dual-ratio prune of every layer. Returns
        (pruned_params, masks) with masks {path: bool mask}."""
        return lstm_policy(spar_x, spar_h).compile(params).prune(params)

    def mask_grads(self, grads, masks):
        """Freeze pruned weights: zero their gradients. Accepts the plan's
        {path: mask} dict or the legacy per-layer list of dicts."""
        if isinstance(masks, dict):
            return _sparse_mask_grads(grads, masks)
        return {**grads, "layers": [
            {**g, "w_x": S.apply_mask(g["w_x"], m["w_x"]),
             "w_h": S.apply_mask(g["w_h"], m["w_h"])}
            for g, m in zip(grads["layers"], masks)]}

    def pack(self, params, masks: dict | None = None, quant=None):
        """Pack pruned layers into per-layer ``{"sx", "sh", "b"}`` with the
        rows padded once to the kernel block (``pad_packed``; not under a
        mesh, whose partition re-splits the rows). ``masks``
        from ``prune`` keeps surviving weights that are exactly zero; with
        None the survivors are re-selected per row by magnitude. ``quant``
        (a scheme name such as ``"int8"`` / ``"q1.11"``, a QuantScheme or a
        QuantConfig) also quantizes each matrix to RowBalancedSparseQ8."""
        fmt = get_format("row_balanced")
        scheme = None
        if quant is not None:
            scheme = parse_scheme(getattr(quant, "scheme", quant))
        packed = []
        for i, lp in enumerate(params["layers"]):
            entry = {"b": lp["b"]}
            for key, out in (("w_x", "sx"), ("w_h", "sh")):
                m = (masks or {}).get(f"layers/{i}/{key}")
                if m is None:
                    m = _survivor_mask(lp[key])
                s = fmt.pack(lp[key], m)
                s = quantize_packed(s, scheme) if scheme else s
                entry[out] = s if self.mesh is not None else pad_packed(s)
            packed.append(entry)
        return packed

    @staticmethod
    def pad_packed_params(packed, block_rows: int = 256):
        """Pad every packed matrix's rows to the kernel-block multiple once,
        so no step re-pads the weight stream. Accepts ``pack``'s per-layer
        list or a ``SparsityPlan.pack``'d tree; dense leaves pass."""
        def _pad(s):
            return pad_packed(s, block_rows) if isinstance(s, _PACKED) else s
        if isinstance(packed, dict) and "layers" in packed:
            return {**packed, "layers": [
                {**lp, "w_x": _pad(lp["w_x"]), "w_h": _pad(lp["w_h"])}
                for lp in packed["layers"]]}
        return [{**lp, "sx": _pad(lp["sx"]), "sh": _pad(lp["sh"])}
                for lp in packed]

    @staticmethod
    def is_packed(params) -> bool:
        return isinstance(params["layers"][0]["w_x"], _PACKED)

    @staticmethod
    def is_quantized(params) -> bool:
        return isinstance(params["layers"][0]["w_x"], RowBalancedSparseQ8)

    def _act_scales(self, i: int):
        """Calibrated (s_x, s_h) activation scales of layer ``i``, or
        (None, None): the q8 wrappers then take dynamic max-abs scales
        (scaled schemes) or the fixed-point constant."""
        if self.quant is None or i >= self.quant.num_layers:
            return (None, None)
        return self.quant.scale_for(i)

    # ------------------------------------------------------------- core
    @staticmethod
    def _cell(z, c_prev, *, pwl=False):
        """z (B, 4H) grouped [f; i; g; o] → (c, h)."""
        H = z.shape[-1] // 4
        return lstm_cell_ref(z[..., :H], z[..., H:2 * H], z[..., 2 * H:3 * H],
                             z[..., 3 * H:], c_prev, pwl=pwl)

    def _scan_layer(self, lp, xs, c0, h0):
        """Dense layer over a sequence: xs (B, T, X_in) → (hs (B, T, H),
        (c_T, h_T))."""
        cell = functools.partial(self._cell, pwl=self.cfg.pwl_activations)
        return TensorParallel(self.mesh).lstm_scan(lp, xs, c0, h0, cell)

    def features(self, params, inputs):
        """inputs: tokens (B, T) ids for a language model, else features
        (B, T, X). Returns the last layer's hidden states (B, T, H)."""
        cfg = self.cfg
        if cfg.vocab_size:
            x = TensorParallel(self.mesh).embed(params["embed"]["table"],
                                                inputs)
        else:
            x = inputs.to(cfg.dtype)
        B = x.shape[0]
        for lp in params["layers"]:
            c0 = torch.zeros((B, cfg.hidden), dtype=cfg.dtype,
                             device=x.device)
            x, _ = self._scan_layer(lp, x, c0, torch.zeros_like(c0))
        return x

    def forward(self, params, inputs):
        """Logits, float32: (B, T, V) for a language model, (B, T, C) for
        a framewise classifier, (B, C) at the last step otherwise."""
        cfg = self.cfg
        hs = self.features(params, inputs)
        head = params["head"]
        logits = TensorParallel(self.mesh).logits(head, hs,
                                                  head["w"].shape[-1])
        return logits if cfg.vocab_size or cfg.framewise else logits[:, -1]

    def loss(self, params, batch):
        """Mean cross-entropy of ``batch`` ({"inputs", "labels"}): next-
        token for a language model, per step for a framewise classifier,
        the last step's for a sequence classifier."""
        cfg = self.cfg
        logits = self.forward(params, batch["inputs"])
        if cfg.vocab_size:
            return cross_entropy(logits[:, :-1], batch["labels"][:, 1:])
        if cfg.framewise:
            return cross_entropy(logits, batch["labels"])
        onehot = torch.nn.functional.one_hot(
            batch["labels"].long(), logits.shape[-1]).float()
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.mean(torch.sum(onehot * logp, dim=-1))

    def sparse_step(self, packed, x_t, state, *, backend: str | None = None):
        """One inference time step on the packed BRDS path, chained (the
        dual-ratio SpMV is the accelerator's Gate module, ``lstm_gates``
        its Function). x_t (B, X); state: list of (c, h) per layer.
        ``packed`` is ``pack``'s per-layer list or a ``SparsityPlan.pack``'d
        tree; quantized packings run the q8 datapath. Returns (h_last,
        new_state)."""
        new_state = []
        inp = x_t
        for i, (lp, (c, h)) in enumerate(zip(self._packed_layers(packed),
                                             state)):
            if isinstance(lp["sx"], RowBalancedSparseQ8):
                ax, ah = self._act_scales(i)
                c, h = K.brds_lstm_step_q8(
                    lp["sx"], inp, lp["sh"], h, lp["b"], c,
                    act_scale_x=ax, act_scale_h=ah,
                    pwl=self.cfg.pwl_activations, backend=backend)
            else:
                c, h = K.brds_lstm_step(lp["sx"], inp, lp["sh"], h, lp["b"],
                                        c, pwl=self.cfg.pwl_activations,
                                        backend=backend)
            new_state.append((c, h))
            inp = h
        return inp, new_state

    def dense_step(self, params, x_t, state):
        """Dense reference step (the contract of ``sparse_step``)."""
        new_state = []
        inp = x_t
        for lp, (c, h) in zip(params["layers"], state):
            z = (inp @ lp["w_x"].T + h @ lp["w_h"].T
                 + lp["b"][None, :]).float()
            c, h = self._cell(z, c, pwl=self.cfg.pwl_activations)
            new_state.append((c, h))
            inp = h
        return inp, new_state

    @staticmethod
    def _packed_layers(packed):
        """The per-layer [{"sx", "sh", "b"}] list, from that list or from a
        ``SparsityPlan.pack``'d tree."""
        if isinstance(packed, dict) and "layers" in packed:
            return [{"sx": lp["w_x"], "sh": lp["w_h"], "b": lp["b"]}
                    for lp in packed["layers"]]
        return packed

    def init_state(self, batch: int, device):
        """Zero (c, h) per layer; under a mesh c is this rank's (B, H/n)
        slice and h the replicated (B, H)."""
        cfg = self.cfg
        zeros = lambda n: torch.zeros((batch, n), dtype=cfg.dtype,
                                      device=device)
        return [(zeros(cfg.hidden // self._shards), zeros(cfg.hidden))
                for _ in range(cfg.num_layers)]

    def cache_defs(self, batch: int, max_len: int) -> dict:
        """Decode-cache declaration: (c, h) per layer. ``max_len`` is part
        of the serving contract but unused — the state is O(1). With a
        ``delta`` rule each layer also carries the reference states
        ``x_ref`` (B, X_in) / ``h_ref`` (B, H), the float32 partial-sum
        memory ``m`` (B, 4H) and the cumulative fired-column counters
        ``nx`` / ``nh`` (B,) that ``occupancy_report`` reduces. Each leaf
        names its logical axes (``"batch"`` first): none is positional, so
        the cache is pure recurrent state (``spec.verify``).

        Under a mesh the declaration is this rank's: ``batch`` is the rows
        the rank steps (the engine splits a batch over ``data``), ``c``
        (axis ``lstm_hidden_shard``) is its (B, H/n) slice and ``m`` its
        (B, 4H/n) gate rows; h, the reference states and the counters are
        replicated (``serving.engine.cache_shardings`` gives the
        placements over the whole batch)."""
        cfg = self.cfg
        n = self._shards
        hid = ("batch", "lstm_hidden")
        c_axes = ("batch", "lstm_hidden_shard") if self.mesh is not None \
            else hid
        defs = {"layers": [
            {"c": L.PSpec((batch, cfg.hidden // n), init="zeros",
                          dtype=cfg.dtype, axes=c_axes),
             "h": L.PSpec((batch, cfg.hidden), init="zeros", dtype=cfg.dtype,
                          axes=hid)}
            for _ in range(cfg.num_layers)]}
        if self.delta is not None:
            f32 = torch.float32
            for i, lp in enumerate(defs["layers"]):
                x_in = cfg.input_size if i == 0 else cfg.hidden
                lp.update({
                    "x_ref": L.PSpec((batch, x_in), init="zeros",
                                     dtype=cfg.dtype, axes=("batch", "embed")),
                    "h_ref": L.PSpec((batch, cfg.hidden), init="zeros",
                                     dtype=cfg.dtype, axes=hid),
                    "m": L.PSpec((batch, 4 * cfg.hidden // n), init="zeros",
                                 dtype=f32, axes=("batch", "lstm_gates")),
                    "nx": L.PSpec((batch,), init="zeros", dtype=f32,
                                  axes=("batch",)),
                    "nh": L.PSpec((batch,), init="zeros", dtype=f32,
                                  axes=("batch",))})
        return defs

    def init_cache(self, batch: int, max_len: int, device):
        return L.init_params(self.cache_defs(batch, max_len), None,
                             torch.device(device))

    def _step(self, params, x_t, state):
        """One time step, packed (float or q8) or dense by param type.
        state/new_state: list of (c, h); returns (h_last, new_state) in
        cfg.dtype."""
        cfg = self.cfg
        packed = self._check_mesh_params(params)
        quantized = packed and self.is_quantized(params)
        if packed and self.mesh is not None:
            from ..dist import collective_ops as C
            scales = ([self._act_scales(i) for i in range(cfg.num_layers)]
                      if quantized else None)
            return C.dist_lstm_step(self.mesh, params["layers"], x_t, state,
                                    pwl=cfg.pwl_activations, dtype=cfg.dtype,
                                    act_scales=scales)
        fused = self._use_fused
        step = K.fused_brds_lstm_step if fused else K.brds_lstm_step
        step_q8 = K.fused_brds_lstm_step_q8 if fused else K.brds_lstm_step_q8
        new_state = []
        inp = x_t
        for i, (lp, (c, h)) in enumerate(zip(params["layers"], state)):
            if quantized:
                ax, ah = self._act_scales(i)
                c, h = step_q8(lp["w_x"], inp, lp["w_h"], h, lp["b"], c,
                               act_scale_x=ax, act_scale_h=ah,
                               pwl=cfg.pwl_activations)
            elif packed:
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

    def _delta_step(self, params, x_t, state):
        """One temporally-sparse time step (the Spartus composition).

        ``state``: per-layer dicts {c, h, x_ref, h_ref, m, nx, nh}. Each
        layer thresholds its input / hidden deltas against the reference
        states and advances the partial-sum memory with the fired columns'
        products only: packed params through the delta kernels (q8 ones
        for quantized params), dense params through a masked-delta matmul.
        Returns (h_last, new_state)."""
        cfg = self.cfg
        d = self.delta
        packed = self._check_mesh_params(params)
        quantized = packed and self.is_quantized(params)
        pwl = cfg.pwl_activations
        if packed and self.mesh is not None:
            from ..dist import collective_ops as C
            # the delta path's doubled scales, as in the loop below
            scales = ([tuple(None if s is None else 2.0 * s
                             for s in self._act_scales(i))
                       for i in range(cfg.num_layers)] if quantized else None)
            return C.dist_delta_lstm_step(self.mesh, params["layers"], x_t,
                                          state, d, pwl=pwl, dtype=cfg.dtype,
                                          act_scales=scales)
        fused = self._use_fused
        new_state = []
        inp = x_t
        for i, (lp, st) in enumerate(zip(params["layers"], state)):
            dx, fx, x_ref = delta_threshold(inp, st["x_ref"], d.theta_x,
                                            d.cap_x)
            dh, fh, h_ref = delta_threshold(st["h"], st["h_ref"], d.theta_h,
                                            d.cap_h)
            if quantized:
                # The calibrated scales bound absolute activations; a delta
                # spans up to twice that range, and a clipped delta would
                # bake its error into the partial-sum memory for good, so
                # this path doubles them (fixed point ignores them).
                ax, ah = (None if s is None else 2.0 * s
                          for s in self._act_scales(i))
                step_q8 = (K.fused_brds_delta_lstm_step_q8 if fused
                           else K.brds_delta_lstm_step_q8)
                c, h, m = step_q8(
                    lp["w_x"], dx, fx, lp["w_h"], dh, fh, st["m"], lp["b"],
                    st["c"], act_scale_x=ax, act_scale_h=ah, pwl=pwl)
            elif packed:
                step = (K.fused_brds_delta_lstm_step if fused
                        else K.brds_delta_lstm_step)
                c, h, m = step(lp["w_x"], dx, fx, lp["w_h"], dh, fh,
                               st["m"], lp["b"], st["c"], pwl=pwl)
            else:
                dxm = torch.where(fx, dx, 0).float()
                dhm = torch.where(fh, dh, 0).float()
                m = (st["m"].float() + dxm @ lp["w_x"].T.float()
                     + dhm @ lp["w_h"].T.float())
                c, h = self._cell(m + lp["b"].float()[None, :], st["c"],
                                  pwl=pwl)
            new_state.append({
                "c": c.to(cfg.dtype), "h": h.to(cfg.dtype),
                "x_ref": x_ref, "h_ref": h_ref, "m": m.float(),
                "nx": st["nx"] + fx.sum(1, dtype=torch.float32),
                "nh": st["nh"] + fh.sum(1, dtype=torch.float32)})
            inp = new_state[-1]["h"]
        return inp, new_state

    def _check_mesh_params(self, params) -> bool:
        """Whether ``params`` is packed; under a mesh it must be (the
        cache holds this rank's slice of c, which only the sharded packed
        step advances)."""
        packed = self.is_packed(params)
        if self.mesh is not None and not packed:
            raise ValueError("LSTMModel(mesh=...) steps partitioned packed "
                             "params only (repro_torch.dist."
                             "partition_lstm_params); serve dense params "
                             "without a mesh")
        return packed

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
        state, step = self._initial(params, xs.shape[1], xs.device)
        hs = []
        for x_t in xs:
            h, state = step(x_t, state)
            hs.append(h)
        logits = self._head_logits(params, torch.stack(hs, 1).flatten(0, 1))
        logits = logits.reshape(xs.shape[1], xs.shape[0], -1)
        if cfg.vocab_size:
            logits, labels = logits[:, :-1], labels[:, 1:]
        return torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long())

    def _initial(self, params, batch: int, device):
        """(initial state, step function) of the serving step path: per-
        layer (c, h) through ``_step``, or the delta cache's layer dicts
        through ``_delta_step``."""
        if self.delta is not None:
            state = self.init_cache(batch, 0, device)["layers"]
            return state, lambda x_t, st: self._delta_step(params, x_t, st)
        return (self.init_state(batch, device),
                lambda x_t, st: self._step(params, x_t, st))

    # ------------------------------------------------------------- serving
    def prefill(self, params, tokens, max_len: int, extra=None, length=None):
        """Process a full prompt and build the decode cache.

        ``length`` (an int or (B,) int tensor) gives the true prompt
        lengths when ``tokens`` is right-padded: steps at t ≥ length
        compute and discard (each sequence's state is frozen), so the
        cache and last-valid logits are what the unpadded prompt gives.
        Every prefill runs this masked body, as the reference does; every
        cache leaf freezes, the delta cache's counters included.

        Returns (logits at the last valid position (B, 1, V), cache).
        """
        cfg = self.cfg
        xs = self._inputs(params, tokens)
        S, B = xs.shape[0], xs.shape[1]
        dev = xs.device
        if length is None:
            length = S
        length = torch.as_tensor(length, dtype=torch.int32, device=dev)
        state, step = self._initial(params, B, dev)
        h_last = torch.zeros((B, cfg.hidden), dtype=cfg.dtype, device=dev)
        for t in range(S):
            h, st2 = step(xs[t], state)
            keep = torch.broadcast_to(t < length, (B,))
            state = _select(keep, st2, state)
            h_last = torch.where(keep[:, None], h, h_last)
        logits = self._head_logits(params, h_last)
        if self.delta is not None:
            return logits, {"layers": state}
        return logits, {"layers": [{"c": c, "h": h} for c, h in state]}

    def decode_step(self, params, cache, tokens, pos):
        """One decode step over the cache. ``pos`` is accepted per the
        serving contract but unused (the recurrent cache has no positions).
        Returns (logits (B, 1, V), cache)."""
        x_t = self._embed_step(params, tokens)
        if self.delta is not None:
            h, new_state = self._delta_step(params, x_t, cache["layers"])
            return self._head_logits(params, h), {"layers": new_state}
        state = [(lp["c"], lp["h"]) for lp in cache["layers"]]
        h, new_state = self._step(params, x_t, state)
        cache = {"layers": [{"c": c, "h": h} for c, h in new_state]}
        return self._head_logits(params, h), cache


def _select(keep: torch.Tensor, new, old):
    """``new`` where ``keep`` (B,) else ``old``, leaf by leaf over a list
    of per-layer tuples or dicts whose leaves lead with the batch axis."""
    if isinstance(new, dict):
        return {k: _select(keep, new[k], old[k]) for k in new}
    if isinstance(new, (list, tuple)):
        return type(new)(_select(keep, n, o) for n, o in zip(new, old))
    return torch.where(keep.reshape((-1,) + (1,) * (new.ndim - 1)), new, old)


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


def packed_q8_from_numpy(values, deltas, scales, ncols: int, qmax: int,
                        frac_bits: int | None = None, pad: int = 0,
                        block_rows: int | None = None,
                        device="cpu") -> RowBalancedSparseQ8:
    """A ``RowBalancedSparseQ8`` from the reference's quantized packed
    arrays (codes, deltas, scales), so the port's kernels run on the very
    codes the reference produced."""
    t = lambda a: torch.tensor(np.asarray(a), device=device)
    return RowBalancedSparseQ8(
        values=t(values), deltas=t(deltas), scales=t(scales),
        ncols=int(ncols), qmax=int(qmax),
        frac_bits=None if frac_bits is None else int(frac_bits),
        pad=int(pad), block_rows=block_rows)


def masked_dense_from_numpy(values, mask, device="cpu") -> MaskedDense:
    """A ``MaskedDense`` (the baseline formats' packing) from the
    reference's (values, mask) arrays."""
    return MaskedDense(values=torch.tensor(np.asarray(values), device=device),
                       mask=torch.tensor(np.asarray(mask), device=device))


def quant_plan_from_scales(scheme, act_scales) -> QuantPlan:
    """A ``QuantPlan`` from a scheme (name or QuantScheme) and the
    reference plan's ``act_scales`` tuple of per-layer (s_x, s_h)."""
    return QuantPlan(scheme=parse_scheme(getattr(scheme, "name", scheme)),
                     act_scales=tuple((float(sx), float(sh))
                                      for sx, sh in act_scales))


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

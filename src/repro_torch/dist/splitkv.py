"""Split-KV sharded decode of every family of the zoo: the dense GQA
transformers (qwen3, llama3.2, minitron, nemotron), the mixture of experts
(granite-moe, qwen3-moe), the encoder-decoder (seamless-m4t), the VLM
(llava, its padded heads), the int8 KV cache, and the recurrent families
(recurrentgemma's RG-LRU and windowed MQA, rwkv6); the port of the
reference's decode under ``param_shardings`` / ``cache_shardings``
(``serving/engine.py``).

The layout (``partition_transformer_params`` and the model's
``cache_defs`` under a mesh):

* **Params** are DTensors laid out by the training rule table
  (``training.param_shardings``): ``wq`` / ``wk`` / ``wv`` / ``wo`` split
  over ``model`` on their heads (a VLM's ``pad_heads_to`` stored heads),
  the MLP on its hidden dim, a mixture's experts on ``experts`` (the
  router's columns too), the embedding and the head on the vocabulary;
  the norms, a VLM's ``patch_norm`` and an encoder-decoder's
  ``frame_proj`` replicated. A dim the axis does not divide stays whole.
* **The KV cache** is split over ``model`` along ``cache_seq``: the rank at
  coordinate j holds positions ``[s0, s1) = [j·S/M, (j+1)·S/M)`` of every
  layer (an int8 cache's codes and scales alike), for the batch rows of
  its ``data`` group; an encoder-decoder's cross memory the same way,
  ``enc_len / M`` positions a rank, of which the frames the prefill
  encoded are live.
* **The recurrent state** splits as the rule table splits it: an RG-LRU
  layer's ``h`` and ``conv`` on the rank's ``d_rnn`` columns (``mlp``), an
  RWKV6 layer's ``S`` on its heads; ``x_tm`` / ``x_cm`` stay whole.

The models under a mesh run their one forward through
``dist.tensor_parallel``'s forms: the embedding on the rank's vocabulary
slice, reduced; q / k / v and the MLP's up products on the rank's heads
and hidden columns; ``wo`` and the down product on its rows, reduced; the
experts on their rank, the partial outputs reduced; the head's columns
gathered. Attention outside training:

* a prefill runs B15 on the rank's heads over the prompt (an encoder's
  and the cross-attention's without a causal mask), and the rank keeps
  the keys and values of every kv head (gathered over ``model`` where
  split) at the positions of its segment, quantized there under
  ``kv_quant``;
* a decode step (``attend``) gathers q / k / v over ``model`` in one
  message (q is head-replicated; the new token's k / v, its int8 codes
  and scales, go to the rank that owns its position), runs B14 on the
  rank's own segment (dequantized) at the local length ``clamp(len - s0,
  0, s1 - s0)`` with its log-sum-exp (``lse=``) (a local-attention
  layer's keys from its first key of the window in the segment, B14's
  ``start=``: ``segment_bounds``; a segment wholly before the window
  weighs 0), and all-gathers (o,
  lse), B·Hq·(D+1) float32, over ``model``, combined with weights
  ``exp(lse_r - max_r lse)`` (``combine``; a rank with no live key weighs
  0); the rank's heads of the result go on to ``wo``'s rows. The cross
  memory (``attend_memory``) is read the same way, every live row of the
  rank's segment;
* with ``pad_heads_to`` only the real heads attend, through the one-device
  q → kv map by their global index; the dummy heads give 0.

Every collective goes through ``collective_ops`` (staged through host
memory where gloo carries card tensors).
"""
from __future__ import annotations

import torch

from ..sharding import mesh_axes
from .collective_ops import distribute, gather_axis
from .partition import axis_rank, model_axis_size

__all__ = ["supports_splitkv", "partition_transformer_params",
           "check_splitkv_partitioned", "cache_segment", "segment_bounds",
           "model_piece", "combine", "merge", "attend", "attend_memory",
           "write_segment", "whole_kv", "prompt_attention"]


def supports_splitkv(model, mesh) -> bool:
    """Whether ``model`` serves tensor-parallel and split-KV over
    ``mesh``: a ``TransformerLM`` (every block kind) or an ``EncDecLM`` on
    a mesh with a ``model`` axis."""
    return (hasattr(model, "with_mesh") and hasattr(model, "tp")
            and "model" in mesh_axes(mesh))


def partition_transformer_params(params, model, mesh):
    """Each rank's piece of ``params`` (the same whole tensors on every
    rank): DTensors laid out by ``training.param_shardings``. A leaf that
    is already a DTensor (a sharded init's) is kept as it is."""
    from torch.distributed.tensor import DTensor
    from ..training.train_loop import param_shardings
    from ..training.tree import leaves, unflatten
    sh = param_shardings(mesh, model)
    return unflatten(params, [x if isinstance(x, DTensor) else
                              distribute(x, s) for x, s in
                              zip(leaves(params), leaves(sh))])


def check_splitkv_partitioned(params) -> None:
    """Raise unless the head is a DTensor (``partition_transformer_params``'
    layout): whole params through the sharded step would read other
    ranks' rows as their own."""
    from torch.distributed.tensor import DTensor
    if not isinstance(params["head"]["w"], DTensor):
        raise ValueError(
            "transformer params are not partitioned over the mesh: serve "
            "the tree ServeEngine(mesh=...).prepare returns "
            "(repro_torch.dist.splitkv.partition_transformer_params)")


def cache_segment(mesh, max_len: int) -> tuple[int, int]:
    """This rank's cache positions [s0, s1): its block of ``max_len`` over
    ``model``."""
    n = model_axis_size(mesh)
    if max_len % n:
        raise ValueError(f"max_len {max_len} does not split over the "
                         f"{n} ranks of the model axis: pick a multiple")
    seg = max_len // n
    j = axis_rank(mesh, "model")
    return j * seg, (j + 1) * seg


def segment_bounds(lengths, s0: int, seg: int, window: int | None):
    """A segment's view of rows of ``lengths`` live positions: (its local
    lengths ``clamp(len - s0, 0, seg)``, and with a ``window`` each row's
    first live key in it, ``clamp(len - window - s0, 0, seg)``, else
    None). Local keys [start, local length) are the window's keys in
    [s0, s0 + seg); a segment wholly before the window has start = seg."""
    loc = (lengths - s0).clamp(0, seg)
    if window is None:
        return loc, None
    return loc, (lengths - window - s0).clamp(0, seg)


def model_piece(mesh, d):
    """The rank's piece of the cache leaf ``d`` (a ``PSpec``): the dims
    its logical axes resolve to ``model`` (the rule table, over its
    shape) cut to 1 / model. The batch dim stays as given (the caller
    passes the rank's rows)."""
    import dataclasses
    from ..sharding import resolve_spec
    n = model_axis_size(mesh)
    shape = list(d.shape)
    for i, entry in enumerate(resolve_spec(mesh, d.axes, d.shape)):
        if entry == "model" or (isinstance(entry, tuple)
                                and "model" in entry):
            shape[i] //= n
    return dataclasses.replace(d, shape=tuple(shape))


def combine(o: torch.Tensor, lse: torch.Tensor, mesh) -> torch.Tensor:
    """The ranks' partial attention outputs o (B, Hq, D) and their
    log-sum-exps (B, Hq), all-gathered over ``model`` in one float32
    message and merged (``merge``). Returns float32 (B, Hq, D), alike on
    every rank."""
    part = torch.cat([o.float(), lse[..., None]], dim=-1)[None]
    parts = gather_axis(part, mesh, "model", 0)
    return merge(parts[..., :-1], parts[..., -1])


def merge(os_: torch.Tensor, ls: torch.Tensor) -> torch.Tensor:
    """Partials o (R, ..., D) with log-sum-exps (R, ...) over R key
    segments → Σ_r w_r o_r / Σ_r w_r, w_r = exp(lse_r − max_r lse). A
    segment with no live key (lse −inf) weighs 0; a row with none in any
    segment gives 0, and no NaN arises."""
    m = ls.amax(0)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(ls - m)                          # exp(-inf) = 0
    den = w.sum(0)
    num = (w[..., None] * os_).sum(0)
    return torch.where(den[..., None] > 0,
                       num / den.clamp_min(1e-30)[..., None],
                       torch.zeros_like(num))


# ---------------------------------------------------------- attention

def write_segment(cache: dict, k, v, pos_b, s0: int) -> None:
    """Write k / v (B, 1, Hkv, D) at each row's position into this rank's
    segment ``cache`` ({"k", "v"} of (B, seg, Hkv, D); int8 codes with
    their ``k_scale`` / ``v_scale``, ``attention.quantize_kv``'s, under
    ``kv_quant``) where the position falls in it, as ``kv_cache_update``
    writes the whole cache."""
    from ..models.attention import quantize_kv
    if "k_scale" in cache:
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        writes = (("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs))
    else:
        writes = (("k", k), ("v", v))
    seg = cache["k"].shape[1]
    loc = pos_b.to(torch.long) - s0
    keep = ((loc >= 0) & (loc < seg))[:, None, None]
    rows = torch.arange(k.shape[0], device=k.device)
    idx = loc.clamp(0, seg - 1)
    for name, new in writes:
        buf = cache[name]
        buf[rows, idx] = torch.where(keep, new[:, 0].to(buf.dtype),
                                     buf[rows, idx])


def _keep_prompt(cache: dict, k, v, s0: int) -> None:
    """The prompt's keys and values (B, S, Hkv, D), every kv head, at the
    positions of this rank's segment into ``cache`` (int8 codes and
    scales under ``kv_quant``: ``quantize_kv`` of each row, as the whole
    cache's)."""
    from ..models.attention import quantize_kv
    seg = cache["k"].shape[1]
    n = min(max(k.shape[1] - s0, 0), seg)
    for name, new in (("k", k), ("v", v)):
        new = new[:, s0:s0 + n]
        if "k_scale" in cache:
            new, cache[f"{name}_scale"][:, :n] = quantize_kv(new)
        cache[name][:, :n] = new


def whole_kv(model, k, v):
    """k / v of every kv head: the rank's pieces gathered over ``model``
    where split."""
    if k.shape[2] < model.cfg.num_kv_heads:
        k = gather_axis(k, model.mesh, "model", 2)
        v = gather_axis(v, model.mesh, "model", 2)
    return k, v


def _every_head(model, q, k, v):
    """q of every stored head and k / v of every kv head (B, 1, H, D),
    each rank's pieces gathered over ``model``: in one message when all
    three are split."""
    cfg, mesh = model.cfg, model.mesh
    if k.shape[2] < cfg.num_kv_heads:
        sizes = [t.shape[2] for t in (q, k, v)]
        whole = gather_axis(torch.cat([q, k, v], dim=2)[:, :, None], mesh,
                            "model", 2)                 # (B, 1, n, ., D)
        return tuple(t.reshape(t.shape[0], t.shape[1], -1, t.shape[-1])
                     for t in torch.split(whole, sizes, dim=3))
    if q.shape[2] < model.h_eff:
        q = gather_axis(q, mesh, "model", 2)
    return q, k, v


def prompt_attention(model, q, k, v, causal: bool,
                     window: int | None = None):
    """B15 of the rank's stored q heads over the prompt's keys (the last
    ``window`` of them a query, for a local-attention layer). With
    ``pad_heads_to``, only the real heads attend, each through the
    one-device q → kv map (global head g reads kv head g // (num_heads /
    Hkv)), cut by their global index (a rank's block of stored heads can
    hold real and dummy heads together); the dummy heads give 0."""
    from ..models import attention as A
    from .tensor_parallel import kv_heads
    cfg, tp = model.cfg, model.tp
    H, hq = cfg.num_heads, q.shape[2]
    if model.h_eff == H:
        return A.prefill_attention(q, *tp.kv_for_q(q, k, v, H,
                                                   cfg.num_kv_heads),
                                   causal=causal, window=window)
    g0 = tp.rank * hq if hq < model.h_eff else 0
    real = min(max(H - g0, 0), hq)
    o = q.new_zeros(q.shape)
    k, v = whole_kv(model, k, v)           # on every rank: a collective
    if real:
        G = H // cfg.num_kv_heads
        o[:, :, :real] = A.prefill_attention(
            q[:, :, :real], *kv_heads(k, v, [(g0 + i) // G
                                             for i in range(real)]),
            causal=causal, window=window)
    return o


def _segment_attention(model, q, kv: dict, length, start=None):
    """B14 of every real head's query q (B, 1, H, D) over this rank's
    segment ``kv`` (B, n, Hkv, D) at its local lengths (from ``start``,
    each row's first live key, where given), with its log-sum-exp, merged
    over ``model`` (``combine``); the dummy heads of ``pad_heads_to`` 0. A
    segment of no rows launches nothing and weighs 0. Returns (B, 1,
    h_eff, D) in q's dtype, alike on every rank."""
    from ..kernels import ops as K
    H = model.cfg.num_heads
    qr = q[:, 0, :H]
    B = q.shape[0]
    if kv["k"].shape[1]:
        lse = torch.empty(B, H, dtype=torch.float32, device=q.device)
        o = K.decode_attention(qr, kv["k"].transpose(1, 2),
                               kv["v"].transpose(1, 2),
                               length.to(torch.int32), lse=lse,
                               start=start)
    else:
        o = torch.zeros_like(qr)
        lse = torch.full((B, H), float("-inf"), device=q.device)
    o = combine(o, lse, model.mesh).to(q.dtype)
    if model.h_eff != H:
        o = torch.cat([o, o.new_zeros(B, model.h_eff - H, o.shape[-1])], 1)
    return o[:, None]


def _rank_heads(model, o, heads: int):
    """The rank's block of ``heads`` stored heads of o (B, S, h_eff, D)
    (all of them where its q is whole)."""
    return o if heads == o.shape[2] else model.tp.rank_slice(o, 2, o.shape[2])


def attend(model, q, k, v, cache, pos, lengths, window=None):
    """The self-attention of ``TransformerLM._attention`` (and of
    ``EncDecLM``'s decoder) under a mesh outside training: q on the rank's
    stored heads, k / v on its kv heads or whole (``TensorParallel.qkv``);
    ``cache`` the layer's segment (bf16, or int8 codes and scales);
    ``window``: a local-attention layer's. Returns the outputs of the
    rank's heads (B, S, h_eff/n, D) (every head's where q is whole). See
    the module docstring."""
    from ..models import attention as A
    seg = cache["k"].shape[1]
    s0 = model.tp.rank * seg
    if lengths is None:                                 # the prompt
        if model.h_eff != model.cfg.num_heads:
            k, v = whole_kv(model, k, v)
        o = prompt_attention(model, q, k, v, causal=True, window=window)
        _keep_prompt(cache, *whole_kv(model, k, v), s0)
        return o
    heads = q.shape[2]
    q, k, v = _every_head(model, q, k, v)
    write_segment(cache, k, v, lengths - 1, s0)
    loc, start = segment_bounds(lengths, s0, seg, window)
    o = _segment_attention(model, q, A.dequantize_cache(cache, q.dtype), loc,
                           start)
    return _rank_heads(model, o, heads)


def attend_memory(model, q, mem: dict):
    """Cross-attention of a decode step under a mesh: q (B, 1, Hq/n, D)
    on the rank's heads over this rank's segment of the encoder's memory
    ``mem`` ({"k", "v"} (B, n, Hkv, D), its n live positions, non-causal),
    merged over ``model``. Returns the rank's heads' outputs."""
    heads = q.shape[2]
    if heads < model.h_eff:
        q = gather_axis(q, model.mesh, "model", 2)
    n = torch.full((q.shape[0],), mem["k"].shape[1], dtype=torch.int32,
                   device=q.device)
    return _rank_heads(model, _segment_attention(model, q, mem, n), heads)

"""Split-KV sharded decode for the dense GQA transformers (qwen3, llama3.2,
minitron, nemotron), the port of the reference's decode under
``param_shardings`` / ``cache_shardings`` (``serving/engine.py``).

The layout (``partition_transformer_params`` and the model's
``cache_defs`` under a mesh):

* **Params** are DTensors laid out by the training rule table
  (``training.param_shardings``): ``wq`` / ``wk`` / ``wv`` / ``wo`` split
  over ``model`` on their heads, the MLP on its hidden dim, the embedding
  and the head on the vocabulary; the norms replicated. A dim the axis
  does not divide stays whole (replicated).
* **The KV cache** is split over ``model`` along ``cache_seq``: the rank at
  coordinate j holds positions ``[s0, s1) = [j·S/M, (j+1)·S/M)`` of every
  layer, for the batch rows of its ``data`` group.

``TransformerLM`` under a mesh runs its one forward (``_run``) through
``dist.tensor_parallel``'s forms: the embedding on the rank's vocabulary
slice, reduced; q / k / v and the MLP's up products on the rank's heads
and hidden columns; ``wo`` and the down product on its rows, reduced; the
head's columns gathered. Its attention outside training is ``attend``:

* a prefill runs B15 on the rank's heads over the prompt, and the rank
  keeps the keys and values of every kv head (gathered over ``model``
  where split) at the positions of its segment;
* a decode step gathers q / k / v over ``model`` in one message (q is
  head-replicated; the new token's k / v go to the rank that owns its
  position), runs B14 on the rank's own segment at the local length
  ``clamp(len - s0, 0, s1 - s0)`` with its log-sum-exp (``lse=``), and
  all-gathers (o, lse), B·Hq·(D+1) float32, over ``model``, combined with
  weights ``exp(lse_r - max_r lse)`` (``combine``; a rank with no live key
  weighs 0); the rank's heads of the result go on to ``wo``'s rows.

Every collective goes through ``collective_ops`` (staged through host
memory where gloo carries card tensors).
"""
from __future__ import annotations

import torch

from ..sharding import mesh_axes
from .collective_ops import distribute, gather_axis
from .partition import axis_rank, model_axis_size

__all__ = ["supports_splitkv", "splitkv_reason", "tp_reason",
           "partition_transformer_params", "check_splitkv_partitioned",
           "cache_segment", "combine", "merge", "attend"]


def tp_reason(cfg) -> str | None:
    """None when ``cfg`` runs tensor-parallel (``dist.tensor_parallel``),
    else why not."""
    if getattr(cfg, "encdec", False):
        return "an encoder-decoder"
    if getattr(cfg, "moe", False):
        return "a mixture of experts"
    if set(cfg.block_pattern) != {"attn"}:
        return f"blocks {sorted(set(cfg.block_pattern))} (recurrent / local)"
    if getattr(cfg, "num_patches", 0) or getattr(cfg, "pad_heads_to", None):
        return "a VLM (patch embeddings, padded heads)"
    return None


def splitkv_reason(cfg) -> str | None:
    """None when ``cfg`` decodes through the split-KV path, else why not."""
    why = tp_reason(cfg)
    if why is None and getattr(cfg, "kv_quant", False):
        return "the int8 KV cache"
    return why


def supports_splitkv(model, mesh) -> bool:
    """Whether ``model`` decodes split-KV over ``mesh``: a dense GQA
    ``TransformerLM`` on a mesh with a ``model`` axis."""
    return (hasattr(model, "with_mesh") and hasattr(model, "kinds")
            and splitkv_reason(model.cfg) is None
            and "model" in mesh_axes(mesh))


def partition_transformer_params(params, model, mesh):
    """Each rank's piece of ``params`` (the same whole tensors on every
    rank): DTensors laid out by ``training.param_shardings``."""
    from ..training.train_loop import param_shardings
    from ..training.tree import leaves, unflatten
    sh = param_shardings(mesh, model)
    return unflatten(params, [distribute(x, s) for x, s in
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

def _write_segment(buf, new, pos_b, s0: int):
    """Write new (B, 1, H, D) at each row's position into this rank's
    segment ``buf`` (B, seg, H, D) where the position falls in it."""
    seg = buf.shape[1]
    loc = pos_b.to(torch.long) - s0
    keep = ((loc >= 0) & (loc < seg))[:, None, None]
    rows = torch.arange(buf.shape[0], device=buf.device)
    idx = loc.clamp(0, seg - 1)
    buf[rows, idx] = torch.where(keep, new[:, 0].to(buf.dtype),
                                 buf[rows, idx])


def _every_head(model, q, k, v):
    """q, k, v of every head (B, 1, H, D), each rank's pieces gathered
    over ``model``: in one message when all three are split."""
    cfg, mesh = model.cfg, model.mesh
    if k.shape[2] < cfg.num_kv_heads:
        sizes = [t.shape[2] for t in (q, k, v)]
        whole = gather_axis(torch.cat([q, k, v], dim=2)[:, :, None], mesh,
                            "model", 2)                 # (B, 1, n, ., D)
        return tuple(t.reshape(t.shape[0], t.shape[1], -1, t.shape[-1])
                     for t in torch.split(whole, sizes, dim=3))
    if q.shape[2] < cfg.num_heads:
        q = gather_axis(q, mesh, "model", 2)
    return q, k, v


def attend(model, q, k, v, cache, pos, lengths):
    """``TransformerLM._attention`` under a mesh outside training: q on
    the rank's heads, k / v on its kv heads or whole (``TensorParallel.
    qkv``); ``cache`` the layer's segment. Returns the outputs of the
    rank's heads (B, S, Hq/n, D) (every head's where q is whole). See the
    module docstring."""
    from ..kernels import ops as K
    from ..models import attention as A
    cfg, tp = model.cfg, model.tp
    seg = cache["k"].shape[1]
    s0 = tp.rank * seg
    if lengths is None:                                 # the prompt
        o = A.prefill_attention(q, *tp.kv_for_q(q, k, v, cfg.num_heads,
                                                 cfg.num_kv_heads))
        if k.shape[2] < cfg.num_kv_heads:
            k = gather_axis(k, model.mesh, "model", 2)
            v = gather_axis(v, model.mesh, "model", 2)
        n = min(max(k.shape[1] - s0, 0), seg)
        cache["k"][:, :n] = k[:, s0:s0 + n]
        cache["v"][:, :n] = v[:, s0:s0 + n]
        return o
    heads = q.shape[2]
    q, k, v = _every_head(model, q, k, v)
    pos_b = lengths - 1
    _write_segment(cache["k"], k, pos_b, s0)
    _write_segment(cache["v"], v, pos_b, s0)
    loc = (lengths - s0).clamp(0, seg).to(torch.int32)
    lse = torch.empty(q.shape[0], q.shape[2], dtype=torch.float32,
                      device=q.device)
    o = K.decode_attention(q[:, 0], cache["k"].transpose(1, 2),
                           cache["v"].transpose(1, 2), loc, lse=lse)
    o = combine(o, lse, model.mesh).to(q.dtype)[:, None]  # (B, 1, Hq, D)
    return o if heads == q.shape[2] else tp.rank_slice(o, 2, q.shape[2])

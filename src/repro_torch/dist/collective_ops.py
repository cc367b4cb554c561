"""Sharded packed-sparse kernels and the sharded LSTM decode steps.

Every function here follows the same collective inventory, the device
analogue of the paper's PE datapath:

* weights enter **row-sharded** over the mesh's ``model`` axis (the
  gate-aligned layout of ``dist.partition``): each rank runs the port's
  ordinary packed kernels (``kernels.ops``) over its own rows, and since
  every row carries exactly NZ survivors the ranks' work is equal;
* activations (``x``, ``h``) enter **replicated**: the broadcast the paper
  feeds its PEs;
* the **only collective of a decode step** is the all-gather of the hidden
  state h (B × H/n a rank) over ``model`` right after the local cell
  update, one a layer. c, the partial-sum memory m and the gate
  preactivations never leave their rank.

Θ-thresholding for the delta path runs on the gathered (replicated)
reference state, so every rank fires the same columns without a
collective of its own.

The steps run the **chained** kernels (the dual SpMV, then the cell): the
all-gather needs the boundary between them. The batch a step is given is
the rank's own rows; the serving engine splits a batch over ``data``
(``batch_axis``) before the prefill and gathers the tokens after decode.

Under gloo, a collective of card tensors is staged through host memory
(``gather_axis``); under NCCL, of host tensors through the card.

Inside ``recording()`` every collective issued here is also recorded:
its kind (the reference's names), the mesh axis, the global ranks of its
group and this rank's payload bytes, the inventory ``launch.dryrun``
reads off a traced step.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.distributed as dist

from ..kernels import ops as K
from ..quant import RowBalancedSparseQ8
from ..sharding import mesh_axes
from ..sparse.temporal import delta_threshold
from .partition import (axis_rank, data_axis_size, local_leaf,
                        model_axis_size, permute_packed_rows, to_dtensor)

__all__ = ["recording", "batch_axis", "gather_axis", "gather_hidden",
           "all_reduce",
           "all_reduce_axis",
           "broadcast_axis", "shard_local", "to_dtensor", "distribute",
           "full_tensor",
           "sharded_rb_dual_spmv", "sharded_delta_rb_dual_spmv",
           "sharded_rb_dual_spmv_q8", "dist_lstm_step",
           "dist_delta_lstm_step"]


_RECORDS: list | None = None


@contextlib.contextmanager
def recording():
    """Record the collectives issued inside: yields a list that gains one
    ``{"kind", "axis", "ranks", "bytes"}`` a collective, in issue order
    (``bytes``: this rank's payload, the tensor it sends)."""
    global _RECORDS
    prev, _RECORDS = _RECORDS, []
    try:
        yield _RECORDS
    finally:
        _RECORDS = prev


def _record(kind: str, t: torch.Tensor, group, axis) -> None:
    if _RECORDS is not None:
        ranks = (dist.get_process_group_ranks(group) if group is not None
                 else list(range(dist.get_world_size())))
        _RECORDS.append({"kind": kind, "axis": axis, "ranks": ranks,
                         "bytes": t.numel() * t.element_size()})


def batch_axis(mesh, batch: int):
    """``"data"`` when the data axis exists, has more than one rank and
    divides ``batch``, else None (replicated batch: the scheduler's
    batch-1 prefills)."""
    d = data_axis_size(mesh)
    return "data" if d > 1 and batch % d == 0 else None


def batch_rows(mesh, batch: int) -> slice:
    """This rank's rows of a ``batch``-row tensor: its data group's
    contiguous block under ``batch_axis``, else every row."""
    if batch_axis(mesh, batch) is None:
        return slice(0, batch)
    per = batch // data_axis_size(mesh)
    r = axis_rank(mesh, "data")
    return slice(r * per, (r + 1) * per)


def gather_axis(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """All-gather ``t`` over the mesh's ``axis`` and concatenate the pieces
    along ``dim`` in rank order (the identity on a one-rank axis)."""
    if mesh_axes(mesh).get(axis, 1) == 1:
        return t
    group = mesh.get_group(axis)
    backend = dist.get_backend(group)
    home = t.device
    if backend == "gloo" and t.is_cuda:
        src = t.detach().cpu()
    elif backend == "nccl" and not t.is_cuda:
        src = t.detach().to(torch.device("cuda", torch.cuda.current_device()))
    else:
        src = t.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    _record("all-gather", src, group, axis)
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(home)


def _staged(t: torch.Tensor, group) -> torch.Tensor:
    """A private copy of ``t`` where ``group``'s backend takes it: host
    memory under gloo, the card under NCCL."""
    backend = dist.get_backend(group)
    if backend == "gloo" and t.is_cuda:
        return t.detach().cpu()
    if backend == "nccl" and not t.is_cuda:
        return t.detach().to(torch.device("cuda",
                                          torch.cuda.current_device()))
    return t.detach().clone()


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def all_reduce(t: torch.Tensor, group=None, op: str = "sum", axis=None):
    """``t`` all-reduced (``op``: sum, max or min) over ``group`` (the
    default group when None), staged where the backend needs: a new
    tensor on ``t``'s device, alike on every rank of the group.
    ``axis``: the mesh axis ``group`` is, for ``recording``."""
    buf = _staged(t, group)
    _record("all-reduce", buf, group, axis)
    dist.all_reduce(buf, op=_OPS[op], group=group)
    return buf.to(t.device)


def all_reduce_axis(t: torch.Tensor, mesh, axes, op: str = "sum"):
    """``t`` all-reduced (``op``: sum, max or min) over the mesh's ``axes``
    (a name or a tuple of names, reduced one after the other; each
    all-reduce leaves every rank of its group the same value). A new
    tensor on ``t``'s device; ``t`` itself is not written."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    sizes = mesh_axes(mesh)
    out = t
    for axis in axes:
        if sizes.get(axis, 1) == 1:
            continue
        out = all_reduce(out, mesh.get_group(axis), op, axis)
    return out if out is not t else t.detach().clone()


def broadcast_axis(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``t`` as the rank at coordinate 0 of each of the mesh's ``axes``
    holds it (a new tensor on ``t``'s device): what makes a value that
    every rank computed alike bitwise alike where the device's sums are
    not deterministic."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    sizes = mesh_axes(mesh)
    out = t
    for axis in axes:
        if sizes.get(axis, 1) == 1:
            continue
        group = mesh.get_group(axis)
        buf = _staged(out, group)
        _record("broadcast", buf, group, axis)
        dist.broadcast(buf, src=dist.get_global_rank(group, 0), group=group)
        out = buf
    return out.to(t.device) if out is not t else t


def shard_local(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's piece of ``full`` under ``placements`` (one a mesh dim):
    each ``Shard(d)`` keeps the rank's contiguous block of dim d, the mesh
    dims taken in order (DTensor's layout). A copy, so ``full`` may go."""
    names = list(mesh_axes(mesh))
    out = full
    for i, pl in enumerate(placements):
        if not pl.is_shard():
            continue
        n = mesh.size(i)
        size = out.shape[pl.dim]
        if size % n:
            raise ValueError(f"dim {pl.dim} of {tuple(full.shape)} does not "
                             f"split over {n} ranks of {names[i]!r}")
        r = mesh.get_local_rank(names[i])
        out = out.narrow(pl.dim, r * (size // n), size // n)
    return out.clone() if out is not full else full


def distribute(full: torch.Tensor, sharding):
    """``full`` laid out by ``sharding`` (a ``sharding.NamedSharding``):
    a DTensor holding this rank's piece. Every rank passes the same
    ``full``; no collective runs."""
    return to_dtensor(shard_local(full, sharding.mesh, sharding.placements),
                      sharding.mesh, sharding.placements, full.shape)


def full_tensor(t):
    """The whole of a DTensor, its pieces all-gathered over each sharded
    mesh dim (the last first) through ``gather_axis``, so staged as the
    backend needs; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor):
        return t
    mesh = t.device_mesh
    names = list(mesh_axes(mesh))
    out = t.to_local()
    for i in reversed(range(len(names))):
        pl = t.placements[i]
        if pl.is_shard():
            out = gather_axis(out, mesh, names[i], pl.dim)
    return out


def gather_hidden(h_loc: torch.Tensor, mesh, axis: str = "model"):
    """All-gather a (B, H/n) hidden shard into the replicated (B, H)
    broadcast: THE collective of a decode step. Shards concatenate in
    rank order, which restores the original hidden order."""
    return gather_axis(h_loc, mesh, axis, h_loc.ndim - 1)


def _check_rows(mesh, *packed):
    n = model_axis_size(mesh)
    for s in packed:
        if s.rows % n:
            raise ValueError(f"packed rows={s.rows} not divisible by the "
                             f"model axis ({n})")


def _row_block(mesh, s):
    """This rank's contiguous block of ``s``'s logical rows."""
    n = model_axis_size(mesh)
    j = axis_rank(mesh, "model")
    per = s.rows // n
    return slice(j * per, (j + 1) * per)


def _sharded(mesh, fn, sx, sh, acts, row_vecs):
    """``fn(sx_rows, sh_rows, *acts_rows, *row_vecs_rows)`` on this rank's
    rows and batch rows, then the (B, R) result gathered over both axes."""
    _check_rows(mesh, sx, sh)
    rows = _row_block(mesh, sx)
    block = np.arange(rows.start, rows.stop)
    b = batch_rows(mesh, acts[0].shape[0])
    out = fn(permute_packed_rows(sx, block), permute_packed_rows(sh, block),
             *(a[b] for a in acts),
             *(v[..., rows] if v.ndim == 1 else v[b][:, rows]
               for v in row_vecs))
    out = gather_axis(out, mesh, "model", 1)
    if batch_axis(mesh, acts[0].shape[0]) is not None:
        out = gather_axis(out, mesh, "data", 0)
    return out


# ------------------------------------------------- sharded kernel wrappers
# Row-sharded twins of the kernels.ops entry points: bitwise the unsharded
# results (each output row comes from exactly one rank, with the same
# per-row arithmetic). They take the UNPERMUTED rows, and every rank gets
# the whole (B, R) result back in order.

def sharded_rb_dual_spmv(mesh, sx, x, sh, h, bias, *,
                         backend: str | None = None):
    """z = Sx@x + Sh@h + bias with the rows split over ``model`` (and the
    batch over ``data`` where it divides); x and h replicated."""
    return _sharded(mesh, lambda a, c, x_, h_, b_: K.rb_dual_spmv(
        a, x_, c, h_, b_, backend=backend), sx, sh, (x, h), (bias,))


def sharded_delta_rb_dual_spmv(mesh, sx, dx, fx, sh, dh, fh, m, *,
                               backend: str | None = None):
    """m' = m + Sx@(fx·dx) + Sh@(fh·dh) with the rows (and m) split over
    ``model``; deltas and fired masks replicated."""
    return _sharded(mesh, lambda a, c, dx_, fx_, dh_, fh_, m_:
                    K.delta_rb_dual_spmv(a, dx_, fx_, c, dh_, fh_, m_,
                                         backend=backend),
                    sx, sh, (dx, fx, dh, fh), (m,))


def sharded_rb_dual_spmv_q8(mesh, sx, x, sh, h, bias, *, act_scale_x=None,
                            act_scale_h=None, backend: str | None = None):
    """The quantized dual-ratio preactivation with rows and per-row scales
    split over ``model``. Each rank quantizes the replicated x and h, so
    every rank gets the same codes (the dynamic max-abs scale reduces over
    the same tensor everywhere)."""
    return _sharded(mesh, lambda a, c, x_, h_, b_: K.rb_dual_spmv_q8(
        a, x_, c, h_, b_, act_scale_x=act_scale_x, act_scale_h=act_scale_h,
        backend=backend), sx, sh, (x, h), (bias,))


# ----------------------------------------------------- sharded decode steps
# One layer-step: the chained kernels on the rank's gate-aligned rows, the
# cell closed over its hidden slice, then the h all-gather that feeds the
# next layer and the next step. Layer params must be partition_lstm_params'
# layout.

def _layer(lp):
    return (local_leaf(lp["w_x"]), local_leaf(lp["w_h"]),
            local_leaf(lp["b"]))


def dist_lstm_step(mesh, layers, x_t, state, *, pwl: bool = False,
                   dtype=torch.float32, act_scales=None,
                   backend: str | None = None):
    """One sharded packed LSTM step (the twin of ``LSTMModel._step``).

    ``layers``: ``partition_lstm_params``' per-layer {w_x, w_h, b};
    ``state``: per-layer (c, h), c the rank's (B, H/n) slice and h the
    replicated (B, H). ``act_scales``: per-layer (s_x, s_h) for q8 layers
    (None entries: the scheme's default). Returns (h_last, new_state),
    bitwise the single-device chained step."""
    inp = x_t
    new = []
    for i, (lp, (c, h)) in enumerate(zip(layers, state)):
        sx, sh, b = _layer(lp)
        if isinstance(sx, RowBalancedSparseQ8):
            ax, ah = act_scales[i] if act_scales else (None, None)
            c2, h2 = K.brds_lstm_step_q8(sx, inp, sh, h, b, c,
                                         act_scale_x=ax, act_scale_h=ah,
                                         pwl=pwl, backend=backend)
        else:
            c2, h2 = K.brds_lstm_step(sx, inp, sh, h, b, c, pwl=pwl,
                                      backend=backend)
        c2 = c2.to(dtype)
        h2 = gather_hidden(h2.to(dtype), mesh)       # THE collective
        new.append((c2, h2))
        inp = h2
    return inp, new


def dist_delta_lstm_step(mesh, layers, x_t, state, delta, *,
                         pwl: bool = False, dtype=torch.float32,
                         act_scales=None, backend: str | None = None):
    """One sharded temporally-sparse step (the twin of ``_delta_step``).

    ``state``: per-layer dicts {c, h, x_ref, h_ref, m, nx, nh}, c and m the
    rank's slices (H/n, 4H/n), the rest replicated. Thresholding runs on
    the replicated state, so every rank derives the same fired sets and
    reference updates. ``act_scales`` arrive already doubled for the
    delta path (the model owns that)."""
    inp = x_t
    new = []
    for i, (lp, st) in enumerate(zip(layers, state)):
        sx, sh, b = _layer(lp)
        dx, fx, x_ref = delta_threshold(inp, st["x_ref"], delta.theta_x,
                                        delta.cap_x)
        dh, fh, h_ref = delta_threshold(st["h"], st["h_ref"], delta.theta_h,
                                        delta.cap_h)
        if isinstance(sx, RowBalancedSparseQ8):
            ax, ah = act_scales[i] if act_scales else (None, None)
            c2, h2, m2 = K.brds_delta_lstm_step_q8(
                sx, dx, fx, sh, dh, fh, st["m"], b, st["c"],
                act_scale_x=ax, act_scale_h=ah, pwl=pwl, backend=backend)
        else:
            c2, h2, m2 = K.brds_delta_lstm_step(
                sx, dx, fx, sh, dh, fh, st["m"], b, st["c"], pwl=pwl,
                backend=backend)
        h2 = gather_hidden(h2.to(dtype), mesh)
        new.append({
            "c": c2.to(dtype), "h": h2, "x_ref": x_ref, "h_ref": h_ref,
            "m": m2.float(),
            "nx": st["nx"] + fx.sum(1, dtype=torch.float32),
            "nh": st["nh"] + fh.sum(1, dtype=torch.float32)})
        inp = h2
    return inp, new

"""Partitioning contract for sharded packed-sparse LSTM decode.

Row balance as device load balance: every row of a ``RowBalancedSparse``
holds exactly NZ survivors, so splitting the 4H gate rows across the mesh's
``model`` axis gives equal shards by construction. Dual ratio means the W_x
and W_h shards carry different NZ, each internally balanced.

The contract (everything in ``repro_torch.dist`` and the LSTM's sharded
decode assume it):

* **Gate-aligned row permutation.** The packed gate rows are laid out
  ``[f; i; g; o]`` (H rows each). Partitioning permutes them to
  ``[f_0; i_0; g_0; o_0; f_1; ...]``, where ``x_j`` is hidden slice
  ``[j·H/n, (j+1)·H/n)`` of gate ``x``, so rank j's contiguous block is a
  complete ``[f; i; g; o]`` layout over its hidden slice and closes the
  cell for those units locally.
* **Values, indices, per-row scales and bias move together** under that
  permutation (the delta-coded column indices are per-row state).
* **Each rank holds its own block** (``partition_lstm_params``): a
  ``DTensor`` over the mesh, ``Shard(0)`` over ``model`` and replicated
  over ``data``, whose local tensor is the block. The placement is the
  witness ``check_partitioned`` reads: unpermuted packed params through
  the sharded step would split the gate rows wrongly and decode garbage
  without an error. Embed and head stay plain (replicated) tensors.
* **Cache layouts** (``LSTMModel.cache_defs`` under a mesh): c and the
  delta path's partial sums m are the rank's slice (H/n, 4H/n); h, the
  reference states and the fired counters are replicated, so
  Θ-thresholding agrees across ranks.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.packing import RowBalancedSparse
from ..quant import RowBalancedSparseQ8
from ..sharding import DEFAULT_RULES, mesh_axes, placements

__all__ = ["model_axis_size", "data_axis_size", "gate_row_permutation",
           "permute_packed_rows", "partition_lstm_params",
           "is_partitionable", "supports_dist", "check_partitioned",
           "local_leaf", "to_dtensor"]

PACKED_TYPES = (RowBalancedSparse, RowBalancedSparseQ8)


def model_axis_size(mesh) -> int:
    """Size of the mesh's ``model`` axis (1 when absent)."""
    return mesh_axes(mesh).get("model", 1)


def data_axis_size(mesh) -> int:
    """Size of the mesh's ``data`` axis (1 when absent)."""
    return mesh_axes(mesh).get("data", 1)


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (0 when the mesh lacks it)."""
    if axis not in mesh_axes(mesh):
        return 0
    return mesh.get_local_rank(axis)


def gate_row_permutation(hidden: int, shards: int) -> np.ndarray:
    """new → old row index map over the 4H gate rows, gate-aligned per
    shard: shard j's block ``[j·4H/n, (j+1)·4H/n)`` holds
    ``[f_j; i_j; g_j; o_j]`` over hidden units ``[j·H/n, (j+1)·H/n)``.

    Examples
    --------
    >>> gate_row_permutation(2, 2).tolist()   # [f0 f1 i0 i1 g0 g1 o0 o1]
    [0, 2, 4, 6, 1, 3, 5, 7]
    """
    if hidden % shards:
        raise ValueError(f"hidden={hidden} not divisible by {shards} shards")
    hs = hidden // shards
    return np.concatenate([
        g * hidden + j * hs + np.arange(hs)
        for j in range(shards) for g in range(4)])


def permute_packed_rows(packed, perm):
    """Row-permute (or select rows of) a packed matrix, or a plain
    row-indexed tensor such as the bias. Values, delta-coded indices and
    per-row scales move together; a padded packing gives its logical rows
    only."""
    idx = torch.as_tensor(np.asarray(perm), dtype=torch.long)
    if isinstance(packed, PACKED_TYPES):
        s = packed.logical()
        rows = {"values": s.values[idx.to(s.values.device)],
                "deltas": s.deltas[idx.to(s.deltas.device)]}
        if isinstance(s, RowBalancedSparseQ8):
            rows["scales"] = s.scales[idx.to(s.scales.device)]
        return dataclasses.replace(s, **rows)
    return packed[idx.to(packed.device)]


def is_partitionable(params) -> bool:
    """Whether ``params`` is a packed LSTM param tree this module shards."""
    try:
        return isinstance(params["layers"][0]["w_x"], PACKED_TYPES)
    except (TypeError, KeyError, IndexError):
        return False


def supports_dist(model, mesh) -> bool:
    """Whether ``model`` can decode through the sharded packed path."""
    return (hasattr(model, "with_mesh")
            and getattr(model, "supports_packed_decode", False)
            and "model" in mesh_axes(mesh))


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def check_partitioned(params, mesh) -> None:
    """Raise unless packed LSTM params carry the partitioned layout.

    The gate-aligned permutation is invisible in the tree structure: the
    witness is the row sharding ``partition_lstm_params`` leaves, packed
    values that are a DTensor sharded over ``model`` on their row dim.
    Dense / unpacked trees pass (nothing to shard)."""
    if model_axis_size(mesh) == 1 or not is_partitionable(params):
        return
    from torch.distributed.tensor import Shard
    v = params["layers"][0]["w_x"].values
    axes = list(mesh_axes(mesh))
    ok = (_is_dtensor(v)
          and v.placements[axes.index("model")] == Shard(0))
    if not ok:
        raise ValueError(
            "packed params are not dist-partitioned (packed values are not "
            "row-sharded over the 'model' axis): serve the tree returned by "
            "repro_torch.dist.partition_lstm_params / ServeEngine(mesh=...)"
            ".prepare — unpartitioned packed params would decode garbage "
            "silently")


def to_dtensor(local: torch.Tensor, mesh, placements, shape):
    """``local`` (this rank's piece) as a DTensor of global ``shape``
    placed by ``placements``; no collective runs."""
    from torch.distributed.tensor import DTensor
    shape = tuple(shape)
    stride = tuple(int(np.prod(shape[i + 1:], dtype=np.int64))
                   for i in range(len(shape)))
    return DTensor.from_local(local, mesh, tuple(placements),
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def _as_dtensor(local: torch.Tensor, mesh, logical, global_rows: int):
    """``local`` (this rank's rows) as a DTensor placed by the rule table
    over a (global_rows, ...) tensor."""
    shape = (global_rows,) + tuple(local.shape[1:])
    return to_dtensor(local, mesh, placements(mesh, logical, shape,
                                              DEFAULT_RULES), shape)


def local_leaf(leaf):
    """The rank's own rows of a partitioned leaf (a packed matrix or the
    bias), as plain tensors the kernels take; anything else as it is."""
    if isinstance(leaf, PACKED_TYPES) and _is_dtensor(leaf.values):
        rows = {"values": leaf.values.to_local(),
                "deltas": leaf.deltas.to_local()}
        if isinstance(leaf, RowBalancedSparseQ8):
            rows["scales"] = leaf.scales.to_local()
        return dataclasses.replace(leaf, **rows)
    if isinstance(leaf, torch.Tensor) and _is_dtensor(leaf):
        return leaf.to_local()
    return leaf


def partition_lstm_params(params, mesh):
    """Shard a ``SparsityPlan.pack``'d LSTM param tree across ``mesh``.

    Every layer's packed ``w_x`` / ``w_h`` (and ``b``, and q8 per-row
    scales) are permuted gate-aligned (``gate_row_permutation``); this rank
    keeps its contiguous block of the permuted rows, wrapped as a DTensor
    sharded over ``model`` (the rule table's ``packed_rows``). Embed and
    head stay as they are (replicated). Serve the result through a model
    carrying the same mesh (``model.with_mesh(mesh)``; ``ServeEngine``
    wires both sides when it holds the mesh)."""
    if not is_partitionable(params):
        raise ValueError(
            "partition_lstm_params wants a SparsityPlan.pack'd LSTM param "
            "tree (layers[*].w_x / w_h packed RowBalancedSparse[Q8])")
    n = model_axis_size(mesh)
    rows = params["layers"][0]["w_x"].rows
    hidden = rows // 4
    if hidden % n:
        raise ValueError(
            f"hidden={hidden} not divisible by model axis size {n}; pick a "
            "mesh whose model axis divides the LSTM hidden size")
    j = axis_rank(mesh, "model")
    block = gate_row_permutation(hidden, n)[j * rows // n:(j + 1) * rows // n]
    out_layers = []
    for lp in params["layers"]:
        entry = {}
        for key, leaf in lp.items():
            if isinstance(leaf, PACKED_TYPES):
                s = permute_packed_rows(leaf, block)
                shard = {"values": _as_dtensor(s.values, mesh,
                                               ("packed_rows", None), rows),
                         "deltas": _as_dtensor(s.deltas, mesh,
                                               ("packed_rows", None), rows)}
                if isinstance(s, RowBalancedSparseQ8):
                    shard["scales"] = _as_dtensor(s.scales, mesh,
                                                  ("packed_rows",), rows)
                entry[key] = dataclasses.replace(s, **shard)
            elif isinstance(leaf, torch.Tensor) and leaf.shape[:1] == (rows,):
                entry[key] = _as_dtensor(permute_packed_rows(leaf, block),
                                         mesh, ("packed_rows",), rows)
            else:
                entry[key] = leaf
        out_layers.append(entry)
    return {k: (out_layers if k == "layers" else v) for k, v in params.items()}

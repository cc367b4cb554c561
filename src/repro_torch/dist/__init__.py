"""repro_torch.dist — sharded packed-sparse decode over torch.distributed.

Row balance as device load balance: every row of a packed
``RowBalancedSparse`` holds exactly NZ survivors, so sharding the 4H gate
rows across a mesh's ``model`` axis yields equal shards by construction.
The mesh is a DeviceMesh over ``(data, model)`` ranks, one process a rank
(``launch.mesh``). Four modules:

  partition      — the partitioning contract: gate-aligned row
                   permutation, each rank's block of the packed values,
                   indices, scales and bias (a DTensor sharded over
                   ``model``: the witness ``check_partitioned`` reads),
                   replicated embed and head.
  collective_ops — sharded kernel wrappers and the sharded LSTM decode
                   steps; a step's only collective is the all-gather of h
                   over ``model``, one a layer. Also the staged
                   collectives (all-gather, all-reduce, broadcast) and
                   the DTensor pieces the sharded train step uses.
  tensor_parallel — Megatron's local forms over ``model`` (column- and
                   row-parallel products, the vocab-parallel embedding,
                   the gathered head, the LSTM's gate rows, the experts
                   on their ranks), their collectives autograd Functions:
                   the sharded train step's forward and backward, and
                   the attention models' prefill and decode under a mesh.
  splitkv        — the attention models' split-KV attention: the KV cache
                   (int8 too) and an encoder-decoder's cross memory split
                   over ``model`` along the sequence, B14's partials
                   combined by their log-sum-exps.

Serving wires it together: ``ServeEngine(..., mesh=mesh)`` partitions at
``prepare`` and decodes model-parallel, the batch split over ``data``;
``ContinuousBatchingEngine(..., mesh=mesh)`` splits its slots over
``data``; an attention model under ``ServeEngine(mesh=)`` decodes
split-KV. ``launch.serve --mesh D,M`` drives it end to end.
"""
from .partition import (check_partitioned, gate_row_permutation,
                        is_partitionable, model_axis_size, data_axis_size,
                        partition_lstm_params, permute_packed_rows,
                        supports_dist)
from .collective_ops import (batch_axis, dist_delta_lstm_step,
                             dist_lstm_step, gather_hidden,
                             sharded_delta_rb_dual_spmv,
                             sharded_rb_dual_spmv, sharded_rb_dual_spmv_q8)

__all__ = [
    "check_partitioned",
    "gate_row_permutation", "is_partitionable", "model_axis_size",
    "data_axis_size", "partition_lstm_params", "permute_packed_rows",
    "supports_dist",
    "batch_axis", "dist_delta_lstm_step", "dist_lstm_step", "gather_hidden",
    "sharded_delta_rb_dual_spmv", "sharded_rb_dual_spmv",
    "sharded_rb_dual_spmv_q8",
]

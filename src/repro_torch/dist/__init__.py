"""repro_torch.dist — sharded packed-sparse decode over torch.distributed.

Row balance as device load balance: every row of a packed
``RowBalancedSparse`` holds exactly NZ survivors, so sharding the 4H gate
rows across a mesh's ``model`` axis yields equal shards by construction.
The mesh is a DeviceMesh over ``(data, model)`` ranks, one process a rank
(``launch.mesh``). Two modules:

  partition      — the partitioning contract: gate-aligned row
                   permutation, each rank's block of the packed values,
                   indices, scales and bias (a DTensor sharded over
                   ``model``: the witness ``check_partitioned`` reads),
                   replicated embed and head.
  collective_ops — sharded kernel wrappers and the sharded LSTM decode
                   steps; a step's only collective is the all-gather of h
                   over ``model``, one a layer.

Serving wires it together: ``ServeEngine(..., mesh=mesh)`` partitions at
``prepare`` and decodes model-parallel, the batch split over ``data``;
``ContinuousBatchingEngine(..., mesh=mesh)`` splits its slots over
``data``. ``launch.serve --mesh D,M`` drives it end to end.
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

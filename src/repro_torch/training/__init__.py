"""Training substrate: optimizers, data, checkpointing, fault tolerance,
masked (BRDS) retraining, gradient compression, and the train step on one
device and sharded over a mesh."""
from .optim import OptConfig, init_state, apply_update, lr_at
from .data import ZipfInduction, CharCorpus, FrameCorpus, ShardedLoader
from .checkpoint import CheckpointManager
from .fault import ResilientLoop, StragglerMonitor, elastic_restore
from .masked import brds_masks, apply_masks, mask_grads, sparsity_report
from .train_loop import (make_train_step, jit_train_step, param_shardings,
                         opt_shardings, batch_shardings)
from . import compression

__all__ = ["OptConfig", "init_state", "apply_update", "lr_at",
           "ZipfInduction", "CharCorpus", "FrameCorpus", "ShardedLoader",
           "CheckpointManager", "ResilientLoop", "StragglerMonitor",
           "elastic_restore", "brds_masks", "apply_masks", "mask_grads",
           "sparsity_report", "make_train_step", "jit_train_step",
           "param_shardings", "opt_shardings", "batch_shardings",
           "compression"]

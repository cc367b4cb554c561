import numpy as np
import torch

from .lstm import (LSTMModel, LSTMConfig, LSTM_CONFIGS, params_from_numpy,
                   packed_from_numpy, packed_q8_from_numpy,
                   masked_dense_from_numpy, quant_plan_from_scales)
from .transformer import TransformerLM

__all__ = ["LSTMModel", "LSTMConfig", "LSTM_CONFIGS", "params_from_numpy",
           "packed_from_numpy", "packed_q8_from_numpy",
           "masked_dense_from_numpy", "quant_plan_from_scales",
           "TransformerLM", "build_model", "transformer_params_from_numpy"]


def build_model(cfg):
    """ArchConfig → model instance; raises ``NotImplementedError`` for the
    families the port cannot serve yet (``transformer.check_supported``)."""
    return TransformerLM(cfg)


def _tensor(a, device) -> torch.Tensor:
    """A numpy array (bfloat16 included, as numpy holds JAX's) → a tensor of
    the same dtype on ``device``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.tensor(a, device=device)


def transformer_params_from_numpy(cfg, tree, device) -> dict:
    """The reference ``TransformerLM``'s param tree as numpy arrays → the
    port's: ``blocks[i]`` (leading dim n_periods, one per block-pattern
    position i) and the ``rem_i`` blocks unstacked into the per-layer list
    (period j's position i is layer j·P + i, the remainder after them),
    dtypes kept."""
    def conv(t, take=None):
        if isinstance(t, dict):
            return {k: conv(v, take) for k, v in t.items()}
        return _tensor(t if take is None else np.asarray(t)[take], device)

    P = len(cfg.block_pattern)
    n_periods = cfg.num_layers // P
    layers = [None] * cfg.num_layers
    for i, stacked in enumerate(tree.get("blocks", ())):
        for j in range(n_periods):
            layers[j * P + i] = conv(stacked, j)
    for i in range(cfg.num_layers % P):
        layers[n_periods * P + i] = conv(tree[f"rem_{i}"])
    out = {k: conv(tree[k]) for k in ("embed", "final_norm", "head")}
    out["layers"] = layers
    return out

import numpy as np
import torch

from .lstm import (LSTMModel, LSTMConfig, LSTM_CONFIGS, params_from_numpy,
                   packed_from_numpy, packed_q8_from_numpy,
                   masked_dense_from_numpy, quant_plan_from_scales)
from .encdec import EncDecLM
from .transformer import TransformerLM

__all__ = ["LSTMModel", "LSTMConfig", "LSTM_CONFIGS", "params_from_numpy",
           "packed_from_numpy", "packed_q8_from_numpy",
           "masked_dense_from_numpy", "quant_plan_from_scales",
           "TransformerLM", "EncDecLM", "build_model",
           "transformer_params_from_numpy", "encdec_params_from_numpy"]


def build_model(cfg):
    """ArchConfig → model instance: ``EncDecLM`` for the encoder-decoder,
    else ``TransformerLM``."""
    return EncDecLM(cfg) if cfg.encdec else TransformerLM(cfg)


def _tensor(a, device) -> torch.Tensor:
    """A numpy array (bfloat16 included, as numpy holds JAX's) → a tensor of
    the same dtype on ``device``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.tensor(a, device=device)


def _conv(t, device, take=None):
    """A numpy tree → tensors, each leaf's entry ``take`` of its leading
    (stacked) dim when given."""
    if isinstance(t, dict):
        return {k: _conv(v, device, take) for k, v in t.items()}
    return _tensor(t if take is None else np.asarray(t)[take], device)


def transformer_params_from_numpy(cfg, tree, device) -> dict:
    """The reference ``TransformerLM``'s param tree as numpy arrays → the
    port's: ``blocks[i]`` (leading dim n_periods, one per block-pattern
    position i) and the ``rem_i`` blocks unstacked into the per-layer list
    (period j's position i is layer j·P + i, the remainder after them),
    dtypes kept (a bf16 config's MoE router stays float32); a VLM's
    ``patch_norm`` carried as it is."""
    P = len(cfg.block_pattern)
    n_periods = cfg.num_layers // P
    layers = [None] * cfg.num_layers
    for i, stacked in enumerate(tree.get("blocks", ())):
        for j in range(n_periods):
            layers[j * P + i] = _conv(stacked, device, j)
    for i in range(cfg.num_layers % P):
        layers[n_periods * P + i] = _conv(tree[f"rem_{i}"], device)
    out = {k: _conv(tree[k], device) for k in ("embed", "final_norm", "head",
                                                "patch_norm") if k in tree}
    out["layers"] = layers
    return out


def encdec_params_from_numpy(cfg, tree, device) -> dict:
    """The reference ``EncDecLM``'s param tree as numpy arrays → the
    port's: ``enc_blocks`` and ``dec_blocks`` (leading dim the layers)
    unstacked into per-layer lists, dtypes kept."""
    out = {k: _conv(v, device) for k, v in tree.items()
           if k not in ("enc_blocks", "dec_blocks")}
    for k, n in (("enc_blocks", cfg.enc_layers or cfg.num_layers),
                 ("dec_blocks", cfg.num_layers)):
        out[k] = [_conv(tree[k], device, i) for i in range(n)]
    return out

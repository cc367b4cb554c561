"""input_specs: stand-ins for every model input of every (arch × shape ×
phase) cell, the port of ``repro/launch/specs.py``.

The reference's ``ShapeDtypeStruct``s become tensors with no data:
``meta`` tensors by default; under a ``FakeTensorMode`` with
``device="cuda"``, fake card tensors, which ``launch.dryrun`` runs a
cell's step on. Nothing is allocated.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig, ShapeConfig
from ..models import build_model
from ..models import layers as L

__all__ = ["input_specs"]


def _spec(shape, dtype, device):
    return torch.empty(tuple(shape), dtype=dtype, device=device)


def input_specs(arch: ArchConfig, shape: ShapeConfig,
                device="meta") -> dict:
    """Stand-in inputs for the phase ``shape.kind`` names, on ``device``:

    train:   {tokens, labels, (patch_embeds | frames)}
    prefill: {tokens, (patch_embeds | frames)}
    decode:  {tokens (B, 1), cache (the model's ``cache_defs``), pos}

    Token ids are int32 and the embeddings in the config's dtype, as the
    reference's."""
    B, S = shape.global_batch, shape.seq_len
    d = arch.d_model
    dt = arch.torch_dtype
    i32 = torch.int32

    if shape.kind == "train":
        if arch.encdec:
            half = S // 2
            return {"tokens": _spec((B, half), i32, device),
                    "labels": _spec((B, half), i32, device),
                    "frames": _spec((B, half, d), dt, device)}
        out = {"tokens": _spec((B, S), i32, device),
               "labels": _spec((B, S), i32, device)}
        if arch.num_patches:
            out["patch_embeds"] = _spec((B, arch.num_patches, d), dt,
                                        device)
        return out

    if shape.kind == "prefill":
        if arch.encdec:
            return {"tokens": _spec((B, S), i32, device),
                    "frames": _spec((B, arch.enc_len, d), dt, device)}
        out = {"tokens": _spec((B, S), i32, device)}
        if arch.num_patches:
            out["patch_embeds"] = _spec((B, arch.num_patches, d), dt,
                                        device)
        return out

    if shape.kind == "decode":
        cache = L.abstract_params(build_model(arch).cache_defs(B, S), device)
        return {"tokens": _spec((B, 1), i32, device), "cache": cache,
                "pos": _spec((), i32, device)}

    raise ValueError(shape.kind)

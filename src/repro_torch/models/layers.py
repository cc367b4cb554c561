"""Parameter declarations and the layers the LSTM needs.

Params are nested dicts / lists of tensors. Structure is declared once as a
tree of ``PSpec`` (shape + init); ``init_params`` turns it into tensors.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class PSpec:
    """Declaration of one parameter tensor. ``axes`` names its logical
    axes (the reference's names: ``"batch"``, ``"lstm_hidden"``, ...),
    one per dimension, or is empty when nothing reads them."""
    shape: tuple
    init: str = "normal"             # normal | zeros
    scale: float | None = None       # stddev override (default 1/sqrt(fan_in))
    dtype: torch.dtype = torch.float32
    axes: tuple = ()

    def __post_init__(self):
        if self.axes and len(self.axes) != len(self.shape):
            raise ValueError(f"axes {self.axes} do not name the "
                             f"{len(self.shape)} dims of {self.shape}")


def _default_scale(shape) -> float:
    # the reference's convention: fan_in is the second-to-last dim
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return 1.0 / math.sqrt(max(fan_in, 1))


def init_params(defs, generator: torch.Generator, device: torch.device):
    """Tensors for a PSpec tree. Normal draws come from ``generator`` (a CPU
    generator) in tree order — dict keys sorted, lists in order — and are
    then moved to ``device``, so a seed gives the same weights on every
    device."""
    if isinstance(defs, dict):
        return {k: init_params(defs[k], generator, device)
                for k in sorted(defs)}
    if isinstance(defs, (list, tuple)):
        return type(defs)(init_params(d, generator, device) for d in defs)
    d = defs
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=device)
    s = d.scale if d.scale is not None else _default_scale(d.shape)
    a = torch.randn(d.shape, generator=generator, dtype=torch.float32) * s
    return a.to(device=device, dtype=d.dtype)


def count_params(defs) -> int:
    if isinstance(defs, dict):
        return sum(count_params(v) for v in defs.values())
    if isinstance(defs, (list, tuple)):
        return sum(count_params(v) for v in defs)
    return math.prod(defs.shape)


def embed_apply(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens]

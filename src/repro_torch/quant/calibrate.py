"""Calibration: QuantConfig (the policy rule) → QuantPlan (the deployment).

Weight scales come from the weights at pack time (per-row max-abs, see
``quantize_packed``); activation scales need data. ``calibrate_lstm`` runs
the dense model over a calibration batch and freezes one float scale per
(layer, path) into a ``QuantPlan`` that the model carries, so decode
quantizes with constants and no per-step reduction. Fixed-point (qM.N)
schemes need no statistics: every scale is 2^-N.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .scheme import QuantScheme, parse_scheme

__all__ = ["QuantConfig", "QuantPlan", "calibrate_lstm", "default_plan"]

_METHODS = ("absmax", "percentile")


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """The policy-side quantization rule.

    scheme: ``"int8"`` or ``"qM.N"``. method: ``"absmax"`` (no activation
    clipping on the batch) or ``"percentile"`` (clips outliers at
    ``percentile`` of |activation|).
    """

    scheme: str = "int8"
    method: str = "absmax"
    percentile: float = 99.9

    def __post_init__(self):
        parse_scheme(self.scheme)  # validate early
        if self.method not in _METHODS:
            raise ValueError(f"method must be one of {_METHODS}, "
                             f"got {self.method!r}")
        if not (0.0 < self.percentile <= 100.0):
            raise ValueError(f"percentile must be in (0, 100], "
                             f"got {self.percentile}")

    @property
    def resolved(self) -> QuantScheme:
        return parse_scheme(self.scheme)


@dataclasses.dataclass(frozen=True)
class QuantPlan:
    """Calibration output: the scheme plus per-layer ``(s_x, s_h)`` float
    activation scales."""

    scheme: QuantScheme
    act_scales: tuple

    def scale_for(self, layer: int) -> tuple[float, float]:
        return self.act_scales[layer]

    @property
    def num_layers(self) -> int:
        return len(self.act_scales)


def _act_scale(x: torch.Tensor, cfg: QuantConfig,
               scheme: QuantScheme) -> float:
    """One static activation scale from a batch of activations."""
    if scheme.frac_bits is not None:
        return scheme.fixed_scale
    a = np.abs(x.detach().float().cpu().numpy())
    amax = (float(np.percentile(a, cfg.percentile))
            if cfg.method == "percentile" else float(a.max()))
    return (amax / scheme.qmax) if amax > 0 else 1.0 / scheme.qmax


@torch.no_grad()
def calibrate_lstm(model, params, tokens: torch.Tensor,
                   cfg: QuantConfig) -> QuantPlan:
    """Run the dense LSTM (``model._scan_layer``) over ``tokens`` ((B, S)
    ids or (B, S, X) frames) with DENSE ``params`` and freeze per-layer
    ``(s_x, s_h)`` activation scales."""
    from ..models import layers as L
    scheme = cfg.resolved
    cfgm = model.cfg
    if cfgm.vocab_size:
        x = L.embed_apply(params["embed"], tokens)
    else:
        x = tokens.to(cfgm.dtype)
    B = x.shape[0]
    scales = []
    for lp in params["layers"]:
        s_x = _act_scale(x, cfg, scheme)
        c0 = torch.zeros((B, cfgm.hidden), dtype=cfgm.dtype, device=x.device)
        hs, _ = model._scan_layer(lp, x, c0, torch.zeros_like(c0))
        s_h = _act_scale(hs, cfg, scheme)
        scales.append((s_x, s_h))
        x = hs
    return QuantPlan(scheme=scheme, act_scales=tuple(scales))


def default_plan(cfg: QuantConfig, num_layers: int) -> QuantPlan:
    """Calibration-free plan: fixed-point schemes need none; scaled schemes
    assume |activation| ≤ 1 (exact for the tanh-bounded hidden path, a
    guess for the input path)."""
    scheme = cfg.resolved
    s = scheme.fixed_scale if scheme.frac_bits is not None \
        else 1.0 / scheme.qmax
    return QuantPlan(scheme=scheme, act_scales=((s, s),) * num_layers)

"""Quantization arithmetic: schemes, (de)quantization, per-row scales.

The BRDS accelerator evaluates its pruned LSTMs in fixed point (the paper's
Table-1 storage is "fixed-16"). This module is the arithmetic of that axis:

  QuantScheme   the number format: symmetric ``int8`` (per-row max-abs
                scales) or paper-style ``qM.N`` fixed point (sign + M
                integer + N fraction bits, one global scale 2^-N; values
                saturate, like the FPGA)
  quantize      x → integer codes  q = clip(round(x / scale), ±qmax)
  dequantize    codes → floats     x̂ = q · scale
  row_scales    per-row dequant scales for a (rows, K) value array

The kernels' wrappers quantize activations with these functions before a
launch, so a kernel and its plain version read the same codes.
"""
from __future__ import annotations

import dataclasses
import re

import torch

__all__ = ["QuantScheme", "parse_scheme", "quantize", "dequantize",
           "row_scales"]

_QMN = re.compile(r"^q(\d+)\.(\d+)$")


def f32_scalar(v, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a 0-dim float32 tensor on ``like``'s device. Dividing by a
    device tensor keeps true float32 division on the card, where PyTorch
    turns division by a Python number into a multiply by its reciprocal."""
    if torch.is_tensor(v):
        return v
    return torch.full((), float(v), dtype=torch.float32, device=like.device)


@dataclasses.dataclass(frozen=True)
class QuantScheme:
    """One number format for quantized inference.

    name: ``"int8"`` or ``"qM.N"``. qmax: the largest positive code (codes
    live in [-qmax, qmax]). frac_bits: None for scaled schemes (per-row
    max-abs scales), N for qM.N fixed point, whose every scale is 2^-N.

    >>> parse_scheme("q1.11").qmax, parse_scheme("q1.11").storage
    (4095, torch.int16)
    """

    name: str
    qmax: int
    frac_bits: int | None = None

    @property
    def storage(self) -> torch.dtype:
        """Narrowest integer dtype holding the codes."""
        return torch.int8 if self.qmax <= 127 else torch.int16

    @property
    def fixed_scale(self) -> float | None:
        """The constant scale 2^-N of a fixed-point scheme (None if
        scaled)."""
        return None if self.frac_bits is None else 2.0 ** -self.frac_bits

    @property
    def bits(self) -> int:
        """Code width in bits (sign included)."""
        return 1 + int(self.qmax).bit_length()

    def act_scale(self, scale):
        """Fixed-point schemes always use 2^-N; scaled schemes use
        ``scale`` (None → the caller derives one)."""
        return self.fixed_scale if self.frac_bits is not None else scale


def parse_scheme(spec) -> QuantScheme:
    """``"int8"`` | ``"qM.N"`` | QuantScheme → QuantScheme.

    ``qM.N`` is sign + M integer + N fraction bits (1+M+N ≤ 16): codes in
    [-(2^(M+N)-1), 2^(M+N)-1], value = code · 2^-N.
    """
    if isinstance(spec, QuantScheme):
        return spec
    if spec == "int8":
        return QuantScheme("int8", qmax=127, frac_bits=None)
    m = _QMN.match(str(spec))
    if not m:
        raise ValueError(f"unknown quant scheme {spec!r}; expected 'int8' "
                         "or 'qM.N' (e.g. 'q1.11')")
    mi, n = int(m.group(1)), int(m.group(2))
    if n < 1 or mi + n > 15:
        raise ValueError(f"qM.N needs 1 <= N and M+N <= 15, got q{mi}.{n}")
    return QuantScheme(f"q{mi}.{n}", qmax=2 ** (mi + n) - 1, frac_bits=n)


def quantize(x: torch.Tensor, scale, scheme: QuantScheme) -> torch.Tensor:
    """x → ``scheme.storage`` codes: ``clip(round(x / scale), ±qmax)``,
    dividing in float32 and rounding half to even. ``scale`` broadcasts
    against ``x`` (a scalar activation scale or per-row
    ``scales[:, None]``)."""
    q = torch.round(x.float() / f32_scalar(scale, x))
    return torch.clamp(q, -scheme.qmax, scheme.qmax).to(scheme.storage)


def dequantize(q: torch.Tensor, scale) -> torch.Tensor:
    """Integer codes → float32 values (``q · scale``)."""
    return q.float() * scale


def row_scales(values: torch.Tensor, scheme: QuantScheme) -> torch.Tensor:
    """Per-row dequant scales (float32, ``values.shape[:-1]``).

    Scaled schemes: max-abs over the row's K packed values / qmax, so the
    row's largest weight maps onto qmax; all-zero rows get 1.0. Fixed-point
    schemes: the constant 2^-N.
    """
    shape = values.shape[:-1]
    if scheme.frac_bits is not None:
        return torch.full(shape, scheme.fixed_scale, dtype=torch.float32,
                          device=values.device)
    amax = values.float().abs().amax(dim=-1)
    return torch.where(amax > 0, amax / f32_scalar(scheme.qmax, amax),
                       torch.ones_like(amax))

"""Quantized packed storage: ``RowBalancedSparseQ8`` and the registered
``row_balanced_q8`` format.

``RowBalancedSparseQ8`` is the quantized twin of
:class:`repro_torch.core.packing.RowBalancedSparse`: the same delta-coded
column indices (quantization never moves a column), integer value codes
instead of floats, and one float32 dequant scale per row. Every row has
exactly K codes, so ``scales[r]`` multiplies a whole row's integer sum in
the kernels' epilogue. Weight bytes shrink by itemsize(f32)/itemsize(codes):
4x for int8, 2x for a qM.N stored in int16.
"""
from __future__ import annotations

import dataclasses
import warnings

import torch

from ..core import packing as P
from ..core import sparsity as S
from ..sparse.formats import SparseFormat, abstract, register
from .scheme import QuantScheme, parse_scheme, quantize, row_scales

__all__ = ["RowBalancedSparseQ8", "quantize_packed", "dequantize_packed",
           "abstract_quantize_packed", "packed_bytes_q",
           "RowBalancedQ8Format"]


@dataclasses.dataclass(frozen=True)
class RowBalancedSparseQ8:
    """Quantized packed row-balanced sparse matrix, logical (rows, ncols).

    values:  (rows, K)  integer value codes (int8 / int16)
    deltas:  (rows, K)  delta-coded column indices, as the float packing's
    scales:  (rows,)    float32 per-row dequant scales
    ncols:   logical column count
    qmax:    largest positive code (symmetric range)
    frac_bits: fixed-point fraction bits, or None for scaled schemes
    pad:     zero rows appended by ``core.packing.pad_packed`` (codes,
             deltas and scales); ``rows`` stays logical
    block_rows: block size the padding targeted (None = unpadded)
    """

    values: torch.Tensor
    deltas: torch.Tensor
    scales: torch.Tensor
    ncols: int
    qmax: int
    frac_bits: int | None = None
    pad: int = 0
    block_rows: int | None = None

    @property
    def rows(self) -> int:
        return self.values.shape[0] - self.pad

    def logical(self) -> "RowBalancedSparseQ8":
        """Padding-free view (slices off ``pad_packed``'s zero rows)."""
        if not self.pad:
            return self
        r = self.rows
        return dataclasses.replace(
            self, values=self.values[:r], deltas=self.deltas[:r],
            scales=self.scales[:r], pad=0, block_rows=None)

    @property
    def K(self) -> int:
        return self.values.shape[1]

    @property
    def scheme(self) -> QuantScheme:
        if self.frac_bits is not None:
            m = int(self.qmax + 1).bit_length() - 1 - self.frac_bits
            name = f"q{m}.{self.frac_bits}"
        else:
            name = "int8" if self.qmax == 127 else f"sym{self.qmax}"
        return QuantScheme(name, qmax=self.qmax, frac_bits=self.frac_bits)

    def col_indices(self) -> torch.Tensor:
        """Absolute column indices (rows, K), int32."""
        return torch.cumsum(self.deltas.to(torch.int32), dim=1,
                            dtype=torch.int32)

    def memory_bytes(self) -> dict:
        """Storage of the logical rows (values + indices + per-row scales)
        against the dense float32 equivalent."""
        n = self.rows * self.K
        v = n * self.values.element_size()
        i = n * self.deltas.element_size()
        sc = self.rows * 4
        dense = self.rows * self.ncols * 4
        return dict(values=v, indices=i, scales=sc, total=v + i + sc,
                    dense_equiv=dense, ratio=(v + i + sc) / dense)


def quantize_packed(s: P.RowBalancedSparse, scheme) -> RowBalancedSparseQ8:
    """Quantize a float packed matrix to codes + per-row scales; the deltas
    pass through untouched."""
    scheme = parse_scheme(scheme)
    scales = row_scales(s.values, scheme)
    q = quantize(s.values, scales[:, None], scheme)
    _check_accumulator(q, scheme)
    return RowBalancedSparseQ8(values=q, deltas=s.deltas, scales=scales,
                               ncols=s.ncols, qmax=scheme.qmax,
                               frac_bits=scheme.frac_bits)


def _check_accumulator(codes: torch.Tensor, scheme: QuantScheme) -> None:
    """Warn when a row's worst-case integer dot can wrap int32.

    The kernels accumulate code products in int32 (wrapping, as the plain
    versions do), bounded per row by ``Σ_k |w_code| · qmax`` since
    activation codes are clipped to ±qmax. int8 cannot reach 2^31; a wide-K
    matrix under a high-qmax ``qM.N`` scheme can, and parity between a
    kernel and its plain version would not show the wrap."""
    worst = int(codes.to(torch.int64).abs().sum(dim=-1).max()) \
        if codes.numel() else 0
    worst *= scheme.qmax
    if worst >= 2 ** 31:
        warnings.warn(
            f"quantize_packed: scheme {scheme.name!r} can overflow the "
            f"int32 kernel accumulator (worst-case per-row dot "
            f"{worst:.3g} >= 2^31); use fewer bits (e.g. 'q1.11') or "
            "higher sparsity (smaller K)", stacklevel=3)


def dequantize_packed(q: RowBalancedSparseQ8) -> P.RowBalancedSparse:
    """The float packing (codes · per-row scales); ``pad_packed``'s rows
    are stripped."""
    q = q.logical()
    vals = q.values.float() * q.scales[:, None]
    return P.RowBalancedSparse(values=vals, deltas=q.deltas, ncols=q.ncols)


def abstract_quantize_packed(rep: P.RowBalancedSparse,
                             scheme) -> RowBalancedSparseQ8:
    """Stand-in of ``quantize_packed`` (``meta`` tensors, for dry runs):
    codes in the scheme's storage, the deltas as they are, one float32
    scale a row."""
    scheme = parse_scheme(scheme)
    return RowBalancedSparseQ8(
        values=abstract(rep.values.shape, scheme.storage),
        deltas=rep.deltas,
        scales=abstract(rep.values.shape[:-1], torch.float32),
        ncols=rep.ncols, qmax=scheme.qmax, frac_bits=scheme.frac_bits)


def packed_bytes_q(rows: int, ncols: int, ratio: float, scheme) -> int:
    """Packed storage of one quantized row-balanced matrix: codes + delta
    indices + one float32 scale per row."""
    scheme = parse_scheme(scheme)
    k = S.keep_count(ncols, ratio)
    dd = P._delta_dtype(ncols, k)
    return rows * k * (scheme.storage.itemsize + dd.itemsize) + rows * 4


class RowBalancedQ8Format(SparseFormat):
    """The registered quantized row-balanced format (``row_balanced_q8``):
    the ``row_balanced`` mask, a ``pack`` that also quantizes (the rule's
    ``scheme`` option, default int8), and a matvec through the q8 kernels
    with a dynamic max-abs activation scale (calibrated static scales come
    in through the model, not this surface)."""

    name = "row_balanced_q8"

    def __init__(self, default_scheme: str = "int8"):
        self.default_scheme = default_scheme

    def mask(self, w, ratio, **opts):
        return S.row_balanced_mask(w, ratio)

    def pack(self, w, mask, scheme: str | None = None, **opts):
        return quantize_packed(P.pack(w, mask),
                               scheme or self.default_scheme)

    def unpack(self, packed):
        return P.unpack(dequantize_packed(packed))

    def abstract_pack(self, rows, ncols, ratio, dtype,
                      scheme: str | None = None, **opts):
        k = S.keep_count(ncols, ratio)
        rep = P.RowBalancedSparse(
            values=abstract((rows, k), torch.float32),
            deltas=abstract((rows, k), P._delta_dtype(ncols, k)),
            ncols=ncols)
        return abstract_quantize_packed(rep, scheme or self.default_scheme)

    def packed_bytes(self, rows, ncols, ratio, dtype,
                     scheme: str | None = None, **opts):
        return packed_bytes_q(rows, ncols, ratio,
                              scheme or self.default_scheme)

    def memory_bytes(self, packed, **opts):
        return packed.memory_bytes()

    def matvec(self, packed, x, *, backend=None):
        from ..kernels import ops as K
        return K.rb_spmv_q8(packed, x, backend=backend).to(x.dtype)

    def dual_matvec(self, pa, x, pb, h, bias=None, *, backend=None):
        from ..kernels import ops as K
        if bias is None:
            bias = torch.zeros((pa.rows,), dtype=torch.float32,
                               device=x.device)
        return K.rb_dual_spmv_q8(pa, x, pb, h, bias,
                                 backend=backend).to(x.dtype)


register(RowBalancedQ8Format())

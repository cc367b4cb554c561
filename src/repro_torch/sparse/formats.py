"""SparseFormat registry — every sparsity pattern the port knows.

A format owns the full lifecycle of its pattern:

  mask(w, ratio)        pruning-mask generation (True = keep)
  pack(w, mask)         packed representation
  unpack(packed)        dense reconstruction (zeros where pruned)
  matvec / dual_matvec  kernel dispatch (backend: "cuda" | "ref" | "auto")
  memory_bytes          storage accounting for the Table-1 analogue

Matrix convention (the accelerator's): logical shape (rows, ncols) with
rows = OUTPUT units and ncols = fan-in, so ``matvec(packed, x)`` maps
x (B, ncols) → y (B, rows) and every row accumulates exactly its own
non-zeros — the balanced-PE invariant.

Registered formats: ``row_balanced`` (the paper's pattern, packed values +
relative-address deltas, served by the ``rb_spmv`` / ``rb_dual_spmv``
kernels), ``bank_balanced`` (BBS [9]), ``block`` and ``unstructured`` (the
Fig.-2 baselines, stored masked-dense with analytic packed-size
accounting; their matvec is a dense product). ``quant.formats`` adds
``row_balanced_q8``. The dry-run stand-ins (``abstract_pack`` /
``abstract_stack``) are ``meta`` tensors of the packed rep's shapes and
dtypes: the torch form of the reference's ``ShapeDtypeStruct``s, no data.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..core import packing as P
from ..core import sparsity as S

__all__ = ["SparseFormat", "MaskedDense", "RowBalancedFormat", "register",
           "get_format", "available_formats", "dual_matvec", "abstract"]


def abstract(shape, dtype) -> torch.Tensor:
    """A ``meta`` tensor of ``shape`` and ``dtype``: a dry run's stand-in
    for a tensor (shape and dtype, no storage)."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


# ------------------------------------------------------------- generic rep

@dataclasses.dataclass(frozen=True)
class MaskedDense:
    """Masked-dense packed form for formats without a dedicated kernel:
    ``values`` is the dense (rows, ncols) matrix with pruned entries zeroed,
    ``mask`` the boolean keep-pattern. The matvec is a dense product, so
    these formats ride the whole prune → pack → serve pipeline; only the
    storage accounting reflects their structure."""

    values: torch.Tensor
    mask: torch.Tensor

    @property
    def rows(self) -> int:
        return self.values.shape[-2]

    @property
    def ncols(self) -> int:
        return self.values.shape[-1]


def _f32_sum(a, b, bias, dtype):
    """(a + b (+ bias)) accumulated in float32, cast to ``dtype``."""
    z = a.float() + b.float()
    if bias is not None:
        z = z + bias.float()[None, :]
    return z.to(dtype)


# ------------------------------------------------------------- base class

class SparseFormat:
    """One sparsity pattern's full lifecycle.

    Subclasses override the pattern-specific pieces and register an
    instance (``register(MyFormat())``); the registry name is then valid
    in any :class:`~repro_torch.sparse.policy.SparsityPolicy` rule.
    ``name`` is the registry key and must be non-empty.
    """

    name: str = ""

    # -- mask generation -----------------------------------------------
    def mask(self, w: torch.Tensor, ratio: float, **opts) -> torch.Tensor:
        """Bool keep-mask of ``w``'s (rows, ncols) shape for pruning the
        fraction ``ratio``; ``opts`` are the rule's pattern options (e.g.
        ``num_banks``, ``block``)."""
        raise NotImplementedError

    # -- packed representation -----------------------------------------
    def pack(self, w: torch.Tensor, mask: torch.Tensor, **opts) -> Any:
        """Packed representation of ``w`` under ``mask``. ``opts`` are the
        rule's pattern options (quantized formats read their scheme here).
        The base is :class:`MaskedDense`; formats with kernels override."""
        return MaskedDense(values=S.apply_mask(w, mask), mask=mask)

    def unpack(self, packed: Any) -> torch.Tensor:
        """Dense (rows, ncols) reconstruction (zeros where pruned)."""
        return packed.values

    def abstract_pack(self, rows: int, ncols: int, ratio: float, dtype,
                      **opts) -> Any:
        """Stand-in of ``pack``'s output (``meta`` tensors, for dry runs):
        the masked-dense values and their bool mask."""
        return MaskedDense(values=abstract((rows, ncols), dtype),
                           mask=abstract((rows, ncols), torch.bool))

    def stack(self, reps: list) -> Any:
        """Combine per-layer packed reps into one rep whose tensors lead
        with the layer axis L."""
        first = reps[0]
        return dataclasses.replace(first, **{
            f.name: torch.stack([getattr(r, f.name) for r in reps])
            for f in dataclasses.fields(first)
            if isinstance(getattr(first, f.name), torch.Tensor)})

    def abstract_stack(self, rep: Any, L: int) -> Any:
        """The stacked stand-in (a leading layer axis L on every tensor)
        of one abstract rep."""
        return dataclasses.replace(rep, **{
            f.name: abstract((L, *getattr(rep, f.name).shape),
                             getattr(rep, f.name).dtype)
            for f in dataclasses.fields(rep)
            if isinstance(getattr(rep, f.name), torch.Tensor)})

    # -- kernels --------------------------------------------------------
    def matvec(self, packed: Any, x: torch.Tensor, *,
               backend: str | None = None) -> torch.Tensor:
        """Sparse matrix × dense batch of vectors: x (B, ncols) → (B, rows)
        in ``x.dtype``. The masked-dense default is a dense float32
        product, the same on every backend."""
        del backend
        return (x.float() @ packed.values.float().T).to(x.dtype)

    def dual_matvec(self, pa: Any, x: torch.Tensor, pb: Any,
                    h: torch.Tensor, bias: torch.Tensor | None = None, *,
                    backend: str | None = None) -> torch.Tensor:
        """z = A@x + B@h (+ bias), the LSTM gate preactivation. Same-format
        pairs may fuse (row_balanced → the dual-family kernel); the default
        is two matvecs accumulated in float32."""
        return _f32_sum(self.matvec(pa, x, backend=backend),
                        self.matvec(pb, h, backend=backend), bias, x.dtype)

    # -- storage accounting --------------------------------------------
    def packed_bytes(self, rows: int, ncols: int, ratio: float, dtype,
                     **opts) -> int:
        """Analytic packed bytes (values + index metadata) of one
        (rows, ncols) matrix pruned at ``ratio``, values in ``dtype``."""
        raise NotImplementedError

    def memory_bytes(self, packed: Any, **opts) -> dict:
        """Accounting of a concrete packed rep: ``values`` / ``indices`` /
        ``total`` bytes, the ``dense_equiv`` bytes and their ``ratio``."""
        raise NotImplementedError

    def _mem_dict(self, values_b: int, index_b: int, rows: int, ncols: int,
                  itemsize: int) -> dict:
        dense = rows * ncols * itemsize
        return dict(values=values_b, indices=index_b,
                    total=values_b + index_b, dense_equiv=dense,
                    ratio=(values_b + index_b) / max(dense, 1))


# ------------------------------------------------------------- registry

_REGISTRY: dict[str, SparseFormat] = {}


def register(fmt: SparseFormat) -> SparseFormat:
    if not fmt.name:
        raise ValueError("format needs a non-empty .name")
    _REGISTRY[fmt.name] = fmt
    return fmt


def get_format(name: str) -> SparseFormat:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown sparse format {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def available_formats() -> list[str]:
    return sorted(_REGISTRY)


def _nnz(packed: MaskedDense) -> int:
    return int(packed.mask.sum())


# --------------------------------------------------------- row_balanced

class RowBalancedFormat(SparseFormat):
    """The paper's pattern: every row keeps exactly K non-zeros; packed as
    (rows, K) values + delta-coded column indices; served by the
    ``rb_spmv`` / ``rb_dual_spmv`` kernels."""

    name = "row_balanced"

    def mask(self, w, ratio, **opts):
        return S.row_balanced_mask(w, ratio)

    def pack(self, w, mask, **opts):
        return P.pack(w, mask)

    def unpack(self, packed):
        return P.unpack(packed)

    def abstract_pack(self, rows, ncols, ratio, dtype, **opts):
        k = S.keep_count(ncols, ratio)
        return P.RowBalancedSparse(
            values=abstract((rows, k), dtype),
            deltas=abstract((rows, k), P._delta_dtype(ncols, k)),
            ncols=ncols)

    def matvec(self, packed, x, *, backend=None):
        from ..kernels import ops as K
        return K.rb_spmv(packed, x, backend=backend)

    def dual_matvec(self, pa, x, pb, h, bias=None, *, backend=None):
        from ..kernels import ops as K
        if bias is None:
            bias = torch.zeros((pa.rows,), dtype=torch.float32,
                               device=x.device)
        return K.rb_dual_spmv(pa, x, pb, h, bias, backend=backend)

    def packed_bytes(self, rows, ncols, ratio, dtype, **opts):
        k = S.keep_count(ncols, ratio)
        dd = P._delta_dtype(ncols, k)
        return rows * k * (dtype.itemsize + dd.itemsize)

    def memory_bytes(self, packed, **opts):
        return packed.memory_bytes()


# --------------------------------------------------------- bank_balanced

class BankBalancedFormat(SparseFormat):
    """BBS [9]: fine-grained pruning inside equal row banks. Stored
    masked-dense; the accounting models per-bank packed values plus one
    narrow in-bank position per non-zero."""

    name = "bank_balanced"

    def mask(self, w, ratio, *, num_banks: int = 4, **opts):
        return S.bank_balanced_mask(w, ratio, num_banks=num_banks)

    @staticmethod
    def _index_bytes(bank: int) -> int:
        """Narrowest int holding an in-bank position."""
        return 1 if bank - 1 <= 255 else 2

    def packed_bytes(self, rows, ncols, ratio, dtype, *, num_banks: int = 4,
                     **opts):
        bank = ncols // num_banks
        k = S.keep_count(bank, ratio)
        return rows * num_banks * k * (dtype.itemsize
                                       + self._index_bytes(bank))

    def memory_bytes(self, packed, *, num_banks: int = 4, **opts):
        nnz = _nnz(packed)
        it = packed.values.element_size()
        idx_b = self._index_bytes(packed.ncols // num_banks)
        return self._mem_dict(nnz * it, nnz * idx_b, packed.rows,
                              packed.ncols, it)


# ----------------------------------------------------------------- block

class BlockFormat(SparseFormat):
    """Block sparsity (Fig. 2c): values of surviving blocks plus a one-bit
    per-block occupancy map."""

    name = "block"

    def mask(self, w, ratio, *, block: tuple[int, int] = (4, 4), **opts):
        return S.block_mask(w, ratio, block=block)

    def packed_bytes(self, rows, ncols, ratio, dtype, *,
                     block: tuple[int, int] = (4, 4), **opts):
        br, bc = block
        nblocks = -(-rows // br) * -(-ncols // bc)
        kept = max(1, nblocks - int(round(ratio * nblocks)))
        return kept * br * bc * dtype.itemsize + (nblocks + 7) // 8

    def memory_bytes(self, packed, **opts):
        nnz = _nnz(packed)
        it = packed.values.element_size()
        bitmap = (packed.mask.numel() + 7) // 8
        return self._mem_dict(nnz * it, bitmap, packed.rows, packed.ncols,
                              it)


# ---------------------------------------------------------- unstructured

class UnstructuredFormat(SparseFormat):
    """Fine-grained global magnitude pruning; the accounting models CSR
    (values + an int32 column index per non-zero + row pointers)."""

    name = "unstructured"

    def mask(self, w, ratio, **opts):
        return S.unstructured_mask(w, ratio)

    def packed_bytes(self, rows, ncols, ratio, dtype, **opts):
        n = rows * ncols
        nnz = max(1, n - int(round(ratio * n)))
        return nnz * (dtype.itemsize + 4) + (rows + 1) * 4

    def memory_bytes(self, packed, **opts):
        nnz = _nnz(packed)
        it = packed.values.element_size()
        return self._mem_dict(nnz * it, nnz * 4 + (packed.rows + 1) * 4,
                              packed.rows, packed.ncols, it)


register(RowBalancedFormat())
register(BankBalancedFormat())
register(BlockFormat())
register(UnstructuredFormat())


# ------------------------------------------------- mixed-format dispatch

def dual_matvec(fmt_a: SparseFormat, pa, x, fmt_b: SparseFormat, pb, h,
                bias=None, *, backend: str | None = None):
    """z = A@x + B@h (+ bias) across possibly different formats. Same-format
    pairs take the format's fused path (row_balanced → the dual-family
    kernel); mixed pairs add two matvecs in float32."""
    if fmt_a is fmt_b:
        return fmt_a.dual_matvec(pa, x, pb, h, bias, backend=backend)
    return _f32_sum(fmt_a.matvec(pa, x, backend=backend),
                    fmt_b.matvec(pb, h, backend=backend), bias, x.dtype)

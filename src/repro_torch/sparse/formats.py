"""SparseFormat registry: the ``row_balanced`` format (the paper's pattern).

A format owns its pattern's mask generation, packed representation and
storage accounting. Matrix convention (the accelerator's): logical shape
(rows, ncols) with rows = output units and ncols = fan-in.

The baseline formats (bank-balanced, block, unstructured) and the
kernel dispatch (``matvec`` needs the ``rb_spmv`` kernel; the LSTM steps
call ``kernels.ops`` directly) are not ported yet.
"""
from __future__ import annotations

from ..core import packing as P
from ..core import sparsity as S

__all__ = ["SparseFormat", "RowBalancedFormat", "register", "get_format"]


class SparseFormat:
    """One sparsity pattern's lifecycle; subclasses register an instance
    under a non-empty ``name``."""

    name: str = ""


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


class RowBalancedFormat(SparseFormat):
    """Every row keeps exactly K non-zeros; packed as (rows, K) values plus
    delta-coded column indices."""

    name = "row_balanced"

    def mask(self, w, ratio, **opts):
        return S.row_balanced_mask(w, ratio)

    def pack(self, w, mask, **opts):
        return P.pack(w, mask)

    def packed_bytes(self, rows, ncols, ratio, dtype, **opts):
        k = S.keep_count(ncols, ratio)
        dd = P._delta_dtype(ncols, k)
        return rows * k * (dtype.itemsize + dd.itemsize)


register(RowBalancedFormat())

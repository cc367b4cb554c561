"""Packed storage for row-balanced sparse matrices.

Each row of a row-balanced sparse matrix has exactly K non-zeros, so the
values pack densely into a (rows, K) array. Column positions use the
paper's relative addressing: the delta between consecutive non-zero
columns of a row, in the narrowest signed integer that holds it. The
kernels rebuild absolute columns with an int32 running sum.
"""
from __future__ import annotations

import dataclasses

import torch

from .sparsity import row_balanced_mask

__all__ = ["RowBalancedSparse", "pack", "unpack", "pack_from_dense",
           "pad_packed"]


@dataclasses.dataclass(frozen=True)
class RowBalancedSparse:
    """Packed row-balanced sparse matrix of logical shape (rows, ncols).

    values:  (rows, K)  non-zero values, row-major by ascending column
    deltas:  (rows, K)  delta-coded column indices (int8/int16/int32);
                        col[r, 0] = deltas[r, 0],
                        col[r, j] = col[r, j-1] + deltas[r, j]
    ncols:   logical column count
    pad:     count of zero rows appended by ``pad_packed`` so the row axis
             is a block multiple; ``rows`` stays logical
    block_rows: block size the padding targeted (None = unpadded)
    """

    values: torch.Tensor
    deltas: torch.Tensor
    ncols: int
    pad: int = 0
    block_rows: int | None = None

    @property
    def rows(self) -> int:
        return self.values.shape[0] - self.pad

    def logical(self) -> "RowBalancedSparse":
        """Padding-free view (slices off ``pad_packed``'s zero rows)."""
        if not self.pad:
            return self
        r = self.rows
        return dataclasses.replace(self, values=self.values[:r],
                                   deltas=self.deltas[:r], pad=0,
                                   block_rows=None)

    @property
    def K(self) -> int:
        return self.values.shape[1]

    @property
    def sparsity(self) -> float:
        return 1.0 - self.K / self.ncols

    def col_indices(self) -> torch.Tensor:
        """Absolute column indices (rows, K), int32."""
        return torch.cumsum(self.deltas.to(torch.int32), dim=1,
                            dtype=torch.int32)

    def memory_bytes(self) -> dict:
        """Storage of the logical rows (``pad_packed``'s zero rows are a
        layout artifact and are not counted)."""
        n = self.rows * self.K
        v = n * self.values.element_size()
        i = n * self.deltas.element_size()
        dense = self.rows * self.ncols * self.values.element_size()
        return dict(values=v, indices=i, total=v + i, dense_equiv=dense,
                    ratio=(v + i) / dense)

    def to(self, device) -> "RowBalancedSparse":
        return dataclasses.replace(self, values=self.values.to(device),
                                   deltas=self.deltas.to(device))


def _delta_dtype(ncols: int, k: int) -> torch.dtype:
    """Narrowest signed int that holds the worst-case column delta
    (ncols - 1: the first delta is an absolute column, the rest gaps)."""
    if ncols - 1 <= 127:
        return torch.int8
    if ncols - 1 <= 32767:
        return torch.int16
    return torch.int32


def pack(w: torch.Tensor, mask: torch.Tensor) -> RowBalancedSparse:
    """Pack a dense matrix + row-balanced mask. Every row of ``mask`` must
    keep the same count K."""
    rows, ncols = w.shape
    counts = mask.sum(dim=1)
    k = int(counts[0])
    if not bool((counts == k).all()):
        raise ValueError("mask is not row-balanced: per-row nnz "
                         f"{torch.unique(counts).tolist()}")
    # masked-out positions sort to the end (key = ncols); the K kept
    # columns come out ascending
    colgrid = torch.arange(ncols, device=w.device).expand(rows, ncols)
    key = torch.where(mask, colgrid, ncols)
    cols = torch.sort(key, dim=1).values[:, :k]
    vals = torch.gather(w, 1, cols)
    cols = cols.to(torch.int32)
    deltas = torch.diff(cols, dim=1,
                        prepend=torch.zeros((rows, 1), dtype=torch.int32,
                                            device=w.device))
    return RowBalancedSparse(values=vals,
                             deltas=deltas.to(_delta_dtype(ncols, k)),
                             ncols=ncols)


def pack_from_dense(w: torch.Tensor, sparsity: float) -> RowBalancedSparse:
    """Row-balanced prune + pack in one step."""
    return pack(w, row_balanced_mask(w, sparsity))


def unpack(s: RowBalancedSparse) -> torch.Tensor:
    """Reconstruct the dense (rows, ncols) matrix (zeros where pruned)."""
    s = s.logical()
    out = torch.zeros((s.rows, s.ncols), dtype=s.values.dtype,
                      device=s.values.device)
    return out.scatter_(1, s.col_indices().long(), s.values)


def pad_packed(s, block_rows: int = 256):
    """Pad the row axis once to a block multiple (zero rows appended,
    ``pad``/``block_rows`` recorded), the layout the reference's kernels
    tile by. The port's kernels consume the arrays as they are and read
    only the logical rows. Takes ``RowBalancedSparse`` and its quantized
    twin ``RowBalancedSparseQ8``, whose per-row ``scales`` pad with zeros
    too. No-op when the rows already divide the block or the struct is
    already padded for it.
    """
    r = s.rows
    eff = min(block_rows, r) if r else block_rows
    pad = (-r) % eff
    if s.pad == pad and (s.block_rows in (None, eff) if pad == 0
                         else s.block_rows == eff):
        return dataclasses.replace(s, block_rows=eff)
    s = s.logical()
    kw = dict(values=torch.nn.functional.pad(s.values, (0, 0, 0, pad)),
              deltas=torch.nn.functional.pad(s.deltas, (0, 0, 0, pad)),
              pad=pad, block_rows=eff)
    if hasattr(s, "scales"):
        kw["scales"] = torch.nn.functional.pad(s.scales, (0, pad))
    return dataclasses.replace(s, **kw)

"""Pruning masks: the paper's row-balanced pattern (§3, Fig. 2e) and the
three baselines it compares against (Fig. 2): unstructured (fine-grained
global), block sparse and bank-balanced (BBS [9]).

Boolean masks with True = keep. A row-balanced mask keeps EXACTLY the same
number of elements in every row. Every ranking is a stable double argsort,
so ties break by position and the masks equal the reference's.
"""
from __future__ import annotations

import torch

__all__ = ["keep_count", "row_balanced_mask", "unstructured_mask",
           "block_mask", "bank_balanced_mask", "apply_mask", "sparsity_of"]


def keep_count(ncols: int, sparsity: float) -> int:
    """Number of elements kept per row at a given sparsity ratio:
    ``ncols - round(Spar * ncols)``, at least 1."""
    k = ncols - int(round(float(sparsity) * ncols))
    return max(1, min(ncols, k))


def _topk_mask_lastdim(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Mask keeping the k largest entries along the last dim.

    Double stable argsort: ties break by position, and exactly k entries
    survive per row.
    """
    order = torch.argsort(-scores, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    return ranks < k


def row_balanced_mask(w: torch.Tensor, sparsity: float) -> torch.Tensor:
    """Prune the smallest ``sparsity`` fraction of |w| along the last dim
    of every row; every row keeps ``keep_count(ncols, sparsity)``."""
    if w.ndim < 2:
        raise ValueError(f"row_balanced_mask expects ≥2-D weight, got "
                         f"{tuple(w.shape)}")
    k = keep_count(w.shape[-1], sparsity)
    return _topk_mask_lastdim(w.abs(), k)


def unstructured_mask(w: torch.Tensor, sparsity: float) -> torch.Tensor:
    """Fine-grained global magnitude pruning (Fig. 2b)."""
    n = w.numel()
    k = max(1, n - int(round(float(sparsity) * n)))
    return _topk_mask_lastdim(w.abs().reshape(-1), k).reshape(w.shape)


def _block_scores(blocks: torch.Tensor) -> torch.Tensor:
    """Mean of each (br, bc) block of ``blocks`` (nbr, nbc, br, bc).

    The sum runs in the order the reference's CPU reduction takes for the
    block shapes the policies use (br a power of two up to 8): each block
    row summed left to right, then the row sums added in halves, (r0 + r2)
    + (r1 + r3) for br = 4. Near-tied blocks then rank as in the
    reference. It is built of elementwise adds, so a card computes the
    same bits as the CPU; the mean divides by a float32 tensor, as true
    division (a Python divisor becomes a reciprocal multiply on the
    card)."""
    br, bc = blocks.shape[-2:]
    rows = []
    for i in range(br):
        acc = blocks[..., i, 0]
        for j in range(1, bc):
            acc = acc + blocks[..., i, j]
        rows.append(acc)
    while len(rows) > 1:
        h = len(rows) // 2
        rows = ([rows[k] + rows[k + h] for k in range(h)]
                + rows[2 * h:])
    return rows[0] / torch.full((), float(br * bc), dtype=rows[0].dtype,
                                device=blocks.device)


def block_mask(w: torch.Tensor, sparsity: float,
               block: tuple[int, int] = (4, 4)) -> torch.Tensor:
    """Block sparsity (Fig. 2c): score each block by its mean |w| and prune
    the lowest-scoring blocks globally. Rows and columns are zero-padded
    to a block multiple; a block of padding alone scores -inf."""
    br, bc = block
    r, c = w.shape
    rp, cp = (-r) % br, (-c) % bc
    wp = torch.nn.functional.pad(w.abs(), (0, cp, 0, rp))
    nbr, nbc = (r + rp) // br, (c + cp) // bc
    score = _block_scores(wp.reshape(nbr, br, nbc, bc).transpose(1, 2))
    dev = w.device
    valid = ((torch.arange(nbr, device=dev) * br < r)[:, None]
             & (torch.arange(nbc, device=dev) * bc < c)[None, :])
    score = torch.where(valid, score, -torch.inf)
    nblocks = nbr * nbc
    kblocks = max(1, nblocks - int(round(float(sparsity) * nblocks)))
    bm = _topk_mask_lastdim(score.reshape(-1), kblocks).reshape(nbr, nbc)
    full = bm.repeat_interleave(br, 0).repeat_interleave(bc, 1)
    return full[:r, :c]


def bank_balanced_mask(w: torch.Tensor, sparsity: float,
                       num_banks: int = 4) -> torch.Tensor:
    """Bank-balanced sparsity (BBS [9], Fig. 2d): split each row into
    ``num_banks`` equal banks and prune fine-grained inside each bank."""
    r, c = w.shape
    if c % num_banks != 0:
        raise ValueError(f"ncols {c} not divisible by num_banks {num_banks}")
    bank = c // num_banks
    k = keep_count(bank, sparsity)
    return _topk_mask_lastdim(w.abs().reshape(r, num_banks, bank),
                              k).reshape(r, c)


def apply_mask(w: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, w, torch.zeros_like(w))


def sparsity_of(mask: torch.Tensor) -> float:
    """Fraction of pruned entries (one host sync)."""
    return float(1.0 - mask.float().mean())

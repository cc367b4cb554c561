"""Gradient compression for the data-parallel all-reduce: int8
quantization with error feedback (EF-SGD style), the port of
``repro/training/compression.py``.

The data-parallel all-reduce of the gradients is the largest collective of
a sharded step. Quantizing it to int8 (one per-tensor scale, agreed by an
all-reduce MAX of each rank's max |g|) quarters the float32 bytes on the
wire; the quantization error stays in a local residual and is added back
at the next step, which preserves convergence.

``compressed_psum`` is the building block, over a process group or one
axis of a DeviceMesh: an all-reduce MAX of a scalar and an all-reduce SUM
of the int8 payload as int32 (``dist.collective_ops.all_reduce``, staged
through host memory where gloo carries card tensors). As in the
reference, the train step does not call it.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .tree import leaves, tree_map, unflatten

__all__ = ["quantize", "dequantize", "compressed_psum", "init_residuals",
           "tree_compressed_psum", "wire_bytes"]


def _error(gf: torch.Tensor, q: torch.Tensor, scale: torch.Tensor):
    """gf - q·scale rounded once, as a fused multiply-add gives it (what
    XLA compiles the reference's expression to): the product of an
    integer below 128 and a float32 is exact in float64, and so is the
    difference, since |gf - q·scale| ≤ scale / 2."""
    return (gf.double() - q.double() * scale.double()).float()


def _scale(gmax: torch.Tensor) -> torch.Tensor:
    """max(gmax, 1e-12) / 127 as XLA compiles the reference's: times the
    float32 reciprocal of 127 (a constant divisor becomes its
    reciprocal), a float32 tensor on the card too."""
    return torch.clamp(gmax, min=1e-12) * torch.tensor(
        1.0 / 127.0, dtype=torch.float32, device=gmax.device)


def quantize(g: torch.Tensor, residual: torch.Tensor | None = None):
    """→ (q int8, scale float32, new_residual): scale = max(max |g|,
    1e-12) / 127 (``_scale``), q = round(g / scale) clipped to ±127 (half
    to even; a true division by a float32 tensor, on the card too), the
    residual rounded once (``_error``)."""
    gf = g.float()
    if residual is not None:
        gf = gf + residual
    scale = _scale(gf.abs().max())
    q = torch.clamp(torch.round(gf / scale), -127, 127)
    return q.to(torch.int8), scale, _error(gf, q, scale)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _group(axis_name, mesh):
    """The process group of ``axis_name``: a mesh axis when ``mesh`` is
    given, else a ProcessGroup (None: the default group)."""
    if mesh is not None:
        return mesh.get_group(axis_name)
    return axis_name


def compressed_psum(g: torch.Tensor, axis_name=None, residual=None, *,
                    mesh=None):
    """All-reduce-mean ``g`` over ``axis_name`` in int8: a process group
    (None: the default group), or, with ``mesh``, the name of one of its
    axes. Two collectives: an all-reduce MAX of max |g + residual| (the
    shared scale) and an all-reduce SUM of the int8 codes as int32.
    Returns (mean float32, new residual)."""
    from ..dist.collective_ops import all_reduce
    group = _group(axis_name, mesh)
    gf = g.float()
    if residual is not None:
        gf = gf + residual
    n = torch.tensor(float(dist.get_world_size(group)), dtype=torch.float32,
                     device=gf.device)
    scale = _scale(all_reduce(gf.abs().max(), group, "max"))
    q = torch.clamp(torch.round(gf / scale), -127, 127)
    new_res = _error(gf, q, scale)
    total = all_reduce(q.to(torch.int32), group, "sum")
    return total.float() * scale / n, new_res


def init_residuals(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def tree_compressed_psum(grads, axis_name, residuals, *, mesh=None):
    """``compressed_psum`` leaf by leaf. Returns (means, new_residuals)."""
    pairs = [compressed_psum(g, axis_name, r, mesh=mesh)
             for g, r in zip(leaves(grads), leaves(residuals))]
    return (unflatten(grads, [p[0] for p in pairs]),
            unflatten(grads, [p[1] for p in pairs]))


def wire_bytes(tree, compressed: bool) -> int:
    """Bytes on the data-parallel wire an all-reduce (payload only)."""
    if compressed:
        return sum(x.numel() for x in leaves(tree))      # int8 payload
    return sum(x.numel() * x.element_size() for x in leaves(tree))

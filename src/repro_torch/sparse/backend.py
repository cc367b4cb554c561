"""Kernel-backend selection for the sparse subsystem.

  "cuda" — the hand-written CUDA kernels (``repro_torch/csrc``); a tensor
           on the CPU raises
  "ref"  — the plain PyTorch versions (``kernels.ref``) on any device
  "auto" — per call, by where the tensor lies: the kernel for a CUDA
           tensor, the plain version for a CPU tensor

The kernel never falls back to the plain version: a CUDA tensor under
"auto" or "cuda" launches the kernel or raises. The process default is set
with ``set_default_backend`` / ``use_backend``. ``from_use_kernel`` maps
the reference's deprecated ``use_kernel=`` boolean: True to "auto" (the
port's kernel cannot run on a CPU tensor, where the reference's Pallas
kernel runs interpreted), False to "ref".
"""
from __future__ import annotations

import contextlib
import warnings

import torch

__all__ = ["BACKENDS", "resolve", "set_default_backend",
           "get_default_backend", "use_backend", "from_use_kernel"]

BACKENDS = ("auto", "ref", "cuda")

_default = "auto"


def get_default_backend() -> str:
    return _default


def set_default_backend(backend: str) -> None:
    global _default
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    _default = backend


@contextlib.contextmanager
def use_backend(backend: str):
    """Scoped override of the process default backend."""
    prev = get_default_backend()
    set_default_backend(backend)
    try:
        yield
    finally:
        set_default_backend(prev)


def resolve(backend: str | None, tensor: torch.Tensor) -> str:
    """Resolve a per-call backend to concrete ``"cuda"`` or ``"ref"`` for
    an operand lying where ``tensor`` lies. None and "auto" defer to the
    process default."""
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    b = _default if backend in (None, "auto") else backend
    if b == "auto":
        return "cuda" if tensor.is_cuda else "ref"
    if b == "cuda" and not tensor.is_cuda:
        raise ValueError(f"backend 'cuda' needs CUDA tensors, got one on "
                         f"{tensor.device}")
    return b


def from_use_kernel(use_kernel: bool, *, stacklevel: int = 3) -> str:
    """Adapter for the deprecated ``use_kernel=`` boolean: True → "auto"
    (the kernel on a CUDA tensor, the plain version on a CPU one), False →
    "ref", with the reference's ``DeprecationWarning``."""
    warnings.warn(
        "use_kernel= is deprecated; pass backend='cuda'|'ref'|'auto' "
        "(see repro_torch.sparse.backend)", DeprecationWarning,
        stacklevel=stacklevel)
    return "auto" if use_kernel else "ref"

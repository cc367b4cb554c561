"""Kernel-backend selection for the sparse subsystem.

  "cuda" — the hand-written CUDA kernels (``repro_torch/csrc``); a tensor
           on the CPU raises
  "ref"  — the plain PyTorch versions (``kernels.ref``) on any device
  "auto" — per call, by where the tensor lies: the kernel for a CUDA
           tensor, the plain version for a CPU tensor

The kernel never falls back to the plain version: a CUDA tensor under
"auto" or "cuda" launches the kernel or raises. The process default is set
with ``set_default_backend`` / ``use_backend``.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["BACKENDS", "resolve", "set_default_backend",
           "get_default_backend", "use_backend"]

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

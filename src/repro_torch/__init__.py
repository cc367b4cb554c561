"""PyTorch + CUDA port of the BRDS reproduction (``repro``).

The module layout mirrors ``repro`` so each module's counterpart is found
under the same path. This package imports ``torch`` only: the CUDA kernels
under ``csrc/`` are compiled with ``nvcc`` at their first launch on a CUDA
tensor (``kernels._build``), so importing it needs no compiler and no card.
"""
from .device import resolve_device

__all__ = ["resolve_device"]

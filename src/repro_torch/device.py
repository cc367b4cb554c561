"""Device selection for the port's entry points.

Entry points (``LSTMModel.init``, ``ServeEngine``, the serve CLI) run on the
card unless the caller asks for the CPU explicitly; without a card they
raise instead of carrying on silently on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; raise if CUDA is requested but unavailable."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev

"""Hand-rolled optimizers: AdamW, SGD-M, Lion — the reference's formulas.

The port of ``repro/training/optim.py``. Optimizer state is a tree shaped
like the params, ``{"m", "v", "count"}`` (AdamW) or ``{"m", "count"}``, the
moments in float32 and ``count`` an int32 scalar. The update clips the
gradients by their float32 global norm, computes in float32 and casts
back to each param's dtype. ``torch.optim.AdamW`` is not this function: it
places the decay, eps and bias correction elsewhere and has no global
clip.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .tree import leaves, tree_map

__all__ = ["OptConfig", "lr_at", "global_norm", "clip_by_global_norm",
           "init_state", "apply_update"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"             # adamw | sgdm | lion
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    schedule: str = "cosine"        # cosine | linear | constant


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def lr_at(cfg: OptConfig, step) -> torch.Tensor:
    """Warmup + cosine / linear decay, a float32 scalar (on the CPU, or
    where ``step`` lies when it is a tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
    elif cfg.schedule == "linear":
        decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * (1 - prog)
    else:
        decay = _f32(1.0)
    return cfg.lr * warm * decay


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum, leaf by leaf in flatten order, of each leaf's
    float32 sum of squares."""
    total = None
    for x in leaves(tree):
        s = torch.sum(torch.square(x.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm(tree, max_norm, norm=None):
    """→ (tree scaled to a global norm ≤ max_norm in float32, the norm).
    ``norm``: the global norm, when ``tree`` is one rank's piece of the
    gradients (the sharded step computes it over the whole)."""
    n = global_norm(tree) if norm is None else norm
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, tree), n


def init_state(cfg: OptConfig, params):
    f32 = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device)
    dev = leaves(params)[0].device
    count = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.name == "adamw":
        return {"m": tree_map(f32, params), "v": tree_map(f32, params),
                "count": count}
    if cfg.name in ("sgdm", "lion"):
        return {"m": tree_map(f32, params), "count": count}
    raise ValueError(cfg.name)


def apply_update(cfg: OptConfig, params, grads, state, step=None,
                 norm=None):
    """Returns (new_params, new_state, metrics); gradients cast to
    float32. ``step`` (default: the state's count) sets the learning rate
    and AdamW's bias correction. ``norm``: the gradients' global norm,
    given when params, grads and state are one rank's pieces (every entry
    is updated on its own, so a piece's update is the whole's). Runs
    without autograd."""
    with torch.no_grad():
        return _apply_update(cfg, params, grads, state, step, norm)


def _apply_update(cfg, params, grads, state, step, norm=None):
    step = state["count"] if step is None else step
    dev = leaves(params)[0].device
    lr = lr_at(cfg, step).to(dev)
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, norm)
    b1, b2 = cfg.betas
    wd = cfg.weight_decay
    count = state["count"] + 1

    if cfg.name == "adamw":
        t = torch.as_tensor(step).to(device=dev, dtype=torch.float32) + 1
        bc1 = 1 - torch.pow(_f32(b1).to(dev), t)
        bc2 = 1 - torch.pow(_f32(b2).to(dev), t)
        new_m = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state["m"],
                         grads)
        new_v = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g,
                         state["v"], grads)

        def upd(p, m, v):
            stepv = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            pf = p.float()
            return (pf - lr * (stepv + wd * pf)).to(p.dtype)

        new_p = tree_map(upd, params, new_m, new_v)
        new_state = {"m": new_m, "v": new_v, "count": count}
    elif cfg.name == "sgdm":
        new_m = tree_map(lambda m, g: b1 * m + g, state["m"], grads)

        def upd(p, m):
            pf = p.float()
            return (pf - lr * (m + wd * pf)).to(p.dtype)

        new_p = tree_map(upd, params, new_m)
        new_state = {"m": new_m, "count": count}
    elif cfg.name == "lion":
        def upd(p, m, g):
            u = torch.sign(b1 * m + (1 - b1) * g)
            pf = p.float()
            return (pf - lr * (u + wd * pf)).to(p.dtype)

        new_p = tree_map(upd, params, state["m"], grads)
        new_m = tree_map(lambda m, g: b2 * m + (1 - b2) * g, state["m"],
                         grads)
        new_state = {"m": new_m, "count": count}
    else:
        raise ValueError(cfg.name)
    return new_p, new_state, {"grad_norm": gnorm, "lr": lr}

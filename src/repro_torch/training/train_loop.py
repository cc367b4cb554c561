"""train_step factory: gradient accumulation and masked (BRDS) retraining
on one device.

The port of ``repro/training/train_loop.py::make_train_step``: autograd
takes the place of ``jax.value_and_grad`` and a Python loop over the
microbatches the place of ``lax.scan``. The sharded forms (ZeRO-1 state,
NamedShardings, ``jit_train_step``) come in slice 19 (ROADMAP queue A
item 7, the training half) and raise.
"""
from __future__ import annotations

import torch

from . import optim
from .tree import leaves, unflatten
from ..sparse import apply_masks, mask_grads

__all__ = ["make_train_step", "param_shardings", "zero1_shardings",
           "opt_shardings", "batch_shardings", "jit_train_step"]


def _unported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet: sharded training comes in slice 19 "
        "(ROADMAP queue A item 7, the training half; the mesh itself is "
        "launch.mesh); make_train_step trains on one device")


def param_shardings(*args, **kwargs):
    raise _unported("param_shardings")


def zero1_shardings(*args, **kwargs):
    raise _unported("zero1_shardings (ZeRO-1 optimizer state)")


def opt_shardings(*args, **kwargs):
    raise _unported("opt_shardings")


def batch_shardings(*args, **kwargs):
    raise _unported("batch_shardings")


def jit_train_step(*args, **kwargs):
    raise _unported("jit_train_step")


def value_and_grad(loss_fn, params, batch):
    """(loss, grads): ``loss_fn(params, batch)`` and its gradient with
    respect to every leaf of ``params``, in each leaf's dtype. A leaf the
    loss does not reach gets a zero gradient, as ``jax.grad`` gives."""
    flat = [p.detach().requires_grad_(True) for p in leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(unflatten(params, flat), batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return loss.detach(), unflatten(params, grads)


def make_train_step(model, arch_cfg, opt_cfg: optim.OptConfig, masks=None):
    """Returns train_step(params, opt_state, batch, step) → (params,
    opt_state, metrics). Gradient accumulation over ``arch_cfg.grad_accum``
    microbatches (float32 sums, each divided by the count). With ``masks``
    ({path: bool mask}) the pruned weights' gradients are zeroed before the
    update and the masks applied again after it. Metrics: ``loss``,
    ``grad_norm`` and ``lr``, 0-d tensors. The params returned carry no
    autograd history."""
    accum = max(1, arch_cfg.grad_accum)

    def train_step(params, opt_state, batch, step):
        if accum == 1:
            loss, grads = value_and_grad(model.loss, params, batch)
        else:
            def mb(i):
                return {k: v.reshape(accum, v.shape[0] // accum,
                                     *v.shape[1:])[i]
                        for k, v in batch.items()}
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in leaves(params)]
            loss = torch.zeros((), dtype=torch.float32,
                               device=grads[0].device)
            for i in range(accum):
                l, g = value_and_grad(model.loss, params, mb(i))
                grads = [a + b.float() / accum
                         for a, b in zip(grads, leaves(g))]
                loss = loss + l / accum
            grads = unflatten(params, grads)
        # grads keep the param dtype here (bf16 for bf16 params), as the
        # reference's do; the optimizer promotes to float32 itself
        if masks is not None:
            grads = mask_grads(grads, masks)
        new_params, new_opt, metrics = optim.apply_update(
            opt_cfg, params, grads, opt_state, step)
        if masks is not None:
            new_params = apply_masks(new_params, masks)
        metrics["loss"] = loss
        return new_params, new_opt, metrics

    return train_step

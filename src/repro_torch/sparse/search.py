"""The BRDS dual-ratio search (paper Fig. 5), walking SparsityPolicy
objects over the (Spar_x, Spar_h) plane.

  phase 1 (lines 1-6):  ramp both ratios 0 → OS in steps of alpha, pruning
                        and retraining at each step → NN_{P,I}.
  phase 2 (lines 7-14): from NN_{P,I}, walk Spar_x up / Spar_h down.
  phase 3 (lines 15-23): reload NN_{P,I}, walk the opposite direction.
  return the tuple with the best model accuracy (line 24).

The search is model-agnostic: ``policy_at(spar_x, spar_h)`` builds the
SparsityPolicy for a tuple (``lstm_policy`` for the paper's LSTM, or any
custom policy factory), and at every visited tuple the policy is compiled
into a plan that prunes the params; ``retrain_fn(params, plan, masks)``
retrains the survivors and ``eval_fn(params)`` scores the result (higher
= better).

``repro_torch.core.brds_search`` keeps the legacy raw-callback signature
as a deprecation shim over the same plane walk. Pure Python: the search
touches params only through the callbacks.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

__all__ = ["BRDSResult", "brds_search", "execution_time_model",
           "plane_search"]


@dataclasses.dataclass
class BRDSResult:
    best_accuracy: float
    best_spar_x: float
    best_spar_h: float
    best_params: Any
    history: list       # list of dicts: phase, spar_x, spar_h, accuracy
    best_policy: Any = None


def plane_search(
    params: Any,
    *,
    overall_sparsity: float,
    visit: Callable,          # (params, spar_x, spar_h) -> (params, aux)
    eval_fn: Callable,        # (params) -> float, higher = better
    alpha: float = 0.25,
    delta_x: float = 0.05,
    delta_h: float = 0.05,
    max_ratio: float = 0.99,
) -> BRDSResult:
    """The Fig.-5 walk, generic over how a tuple is applied. ``visit``
    prunes+retrains params at one (spar_x, spar_h) tuple and returns the
    new params plus an aux object recorded for the best tuple (the new API
    passes the SparsityPolicy; the legacy shim passes None)."""
    os_ = float(overall_sparsity)
    history: list[dict] = []

    # ---- phase 1: ramp to the initial point NN_{P,I} (lines 1-6)
    spar_x = spar_h = 0.0
    aux = None
    while spar_x < os_ and spar_h < os_:
        spar_x = min(os_, spar_x + alpha)
        spar_h = min(os_, spar_h + alpha)
        params, aux = visit(params, spar_x, spar_h)
    nn_pi = params
    acc = float(eval_fn(params))
    best = BRDSResult(acc, spar_x, spar_h, params, history, aux)
    history.append(dict(phase="init", spar_x=spar_x, spar_h=spar_h,
                        accuracy=acc))

    def _walk(params, sx, sh, dx, dh, phase):
        nonlocal best
        while 0.0 < sx + dx <= max_ratio and 0.0 <= sh - dh < max_ratio:
            sx = min(max_ratio, sx + dx)
            sh = max(0.0, sh - dh)
            params, aux = visit(params, sx, sh)
            acc = float(eval_fn(params))
            history.append(dict(phase=phase, spar_x=sx, spar_h=sh,
                                accuracy=acc))
            if acc > best.best_accuracy:
                best = BRDSResult(acc, sx, sh, params, history, aux)
            if sx >= max_ratio or sh <= 0.0:
                break
        return params

    # ---- phase 2: Spar_x up, Spar_h down (lines 7-14)
    _walk(nn_pi, spar_x, spar_h, +delta_x, +delta_h, phase="x_up")
    # ---- phase 3: reload NN_{P,I}; Spar_x down, Spar_h up (lines 15-23)
    _walk(nn_pi, spar_x, spar_h, -delta_x, -delta_h, phase="h_up")

    best.history = history
    return best


def brds_search(
    params: Any,
    *,
    overall_sparsity: float,
    policy_at: Callable,      # (spar_x, spar_h) -> SparsityPolicy
    retrain_fn: Callable,     # (params, plan, masks) -> params
    eval_fn: Callable,        # (params) -> float, higher = better
    alpha: float = 0.25,
    delta_x: float = 0.05,
    delta_h: float = 0.05,
    max_ratio: float = 0.99,
) -> BRDSResult:
    """Run the Fig.-5 search over SparsityPolicy objects."""

    def visit(p, sx, sh):
        policy = policy_at(sx, sh)
        plan = policy.compile(p)
        pruned, masks = plan.prune(p)
        return retrain_fn(pruned, plan, masks), policy

    return plane_search(params, overall_sparsity=overall_sparsity,
                        visit=visit, eval_fn=eval_fn, alpha=alpha,
                        delta_x=delta_x, delta_h=delta_h,
                        max_ratio=max_ratio)


def execution_time_model(os_: float, alpha: float, delta_x: float,
                         delta_h: float, ept: float, n_re: int) -> dict:
    """The paper's cost model, eqs. (3)-(6). Ratios in percent or fractions
    (consistent units). Returns the per-phase and total times."""
    ex1 = (os_ / alpha) * ept * n_re
    ex2 = min((1.0 - os_) / delta_x, os_ / delta_h) * ept * n_re
    ex3 = min((1.0 - os_) / delta_h, os_ / delta_x) * ept * n_re
    return dict(ex1=ex1, ex2=ex2, ex3=ex3, total=ex1 + ex2 + ex3)

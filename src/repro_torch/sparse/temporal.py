"""Temporal delta sparsity: Spartus-style activation skipping.

BRDS prunes the weights; across decode steps most components of the LSTM
input x_t and hidden state h_{t-1} also barely change. A delta datapath
keeps a reference state per activation vector and a partial-sum memory m
per gate preactivation, and each step computes only the columns whose
delta crossed a threshold Θ:

    d     = v_t - ref                  (raw delta)
    fired = |d| > Θ                    (optionally capped, see below)
    ref'  = fired ? v_t : ref
    m'    = m + W @ (fired · d)        (only fired columns' products)
    z_t   = m' + bias

With Θ = 0 every changed column fires, the reference tracks the input
exactly, and the trajectory reproduces packed decode up to float
re-association. The optional occupancy cap bounds the fired-column count
per step (largest |delta| first): the activation-side analogue of row
balance.

``DeltaGateConfig`` is the declaration serving carries: per-family
thresholds and caps. ``lstm_policy(..., delta=cfg)`` carries it and
``ServeEngine.prepare`` wires it into the model's decode cache.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["DeltaGateConfig", "cap_count", "delta_threshold",
           "occupancy_report"]


def cap_count(cap: float | None, n: int) -> int | None:
    """Fired-column budget for an occupancy cap over ``n`` columns (at
    least 1), or None when uncapped or the cap admits every column.

    >>> cap_count(0.25, 128), cap_count(0.001, 128), cap_count(1.0, 128)
    (32, 1, None)
    """
    if cap is None:
        return None
    k = max(1, int(round(cap * n)))
    return None if k >= n else k


@dataclasses.dataclass(frozen=True)
class DeltaGateConfig:
    """Declaration of a temporal-delta gate (the activation-side rule).

    theta_x / theta_h: thresholds Θ for the input path (columns of W_x)
    and the recurrent path (columns of W_h); 0.0 fires every changed
    component (exact decode). cap_x / cap_h: optional occupancy caps in
    (0, 1]: at most ``cap * width`` columns fire per step.
    """

    theta_x: float = 0.0
    theta_h: float = 0.0
    cap_x: float | None = None
    cap_h: float | None = None

    def __post_init__(self):
        for name in ("theta_x", "theta_h"):
            if getattr(self, name) < 0.0:
                raise ValueError(f"{name} must be >= 0, "
                                 f"got {getattr(self, name)}")
        for name in ("cap_x", "cap_h"):
            v = getattr(self, name)
            if v is not None and not (0.0 < v <= 1.0):
                raise ValueError(f"{name} must be in (0, 1], got {v}")


def delta_threshold(v: torch.Tensor, ref: torch.Tensor, theta: float,
                    cap: float | None = None):
    """Threshold one (B, N) activation's delta against its reference.

    Returns ``(d, fired, new_ref)``: the raw delta ``v - ref``, the bool
    fired mask ``|d| > theta`` and the reference updated to ``v`` where
    fired. At Θ = 0 ``new_ref`` equals ``v`` bit for bit. With ``cap``, at
    most ``cap_count(cap, N)`` columns per row stay fired, largest |d|
    first, ties broken toward the lower column (a stable descending sort:
    ``torch.topk`` promises no order among equal values).
    """
    d = (v - ref).to(v.dtype)
    fired = d.abs() > theta
    k = cap_count(cap, v.shape[-1])
    if k is not None:
        score = torch.where(fired, d.abs().float(),
                            torch.full_like(d, -torch.inf, dtype=torch.float32))
        top = torch.sort(score, dim=-1, descending=True, stable=True)
        keep = top.values[:, :k] > -torch.inf
        fired = torch.zeros_like(fired).scatter_(-1, top.indices[:, :k], keep)
    new_ref = torch.where(fired, v, ref)
    return d, fired, new_ref


def occupancy_report(cache, *, steps, packed=None) -> dict:
    """Fired-column occupancy from a delta decode cache.

    ``cache``: ``{"layers": [{"nx", "nh", "x_ref", "h_ref", ...}]}`` whose
    per-sequence counters accumulated over ``steps`` decode steps (a scalar
    for a lockstep batch, or a (B,) vector). With ``packed`` (the packed
    params), also the MAC-weighted reduction against always-on packed
    decode: ``effective_macs``, ``packed_macs`` and ``ops_reduction``.
    The counters are read with one host sync.
    """
    layers = cache["layers"]
    B = layers[0]["x_ref"].shape[0]
    steps_b = torch.broadcast_to(torch.as_tensor(steps, dtype=torch.float64),
                                 (B,))
    step_sum = float(steps_b.sum())
    counts = torch.stack([torch.stack([lp["nx"].sum(), lp["nh"].sum()])
                          for lp in layers]).double().cpu().tolist()
    fx = fh = tx = th = eff = total = 0.0
    for i, (lp, (nx, nh)) in enumerate(zip(layers, counts)):
        X, H = lp["x_ref"].shape[1], lp["h_ref"].shape[1]
        fx += nx
        fh += nh
        tx += step_sum * X
        th += step_sum * H
        if packed is not None:
            sx = packed["layers"][i]["w_x"]
            sh = packed["layers"][i]["w_h"]
            # MACs per fired column: the family's nnz per column, R*K/N
            eff += nx * sx.rows * sx.K / X + nh * sh.rows * sh.K / H
            total += step_sum * (sx.rows * sx.K + sh.rows * sh.K)
    out = dict(occupancy_x=fx / max(tx, 1), occupancy_h=fh / max(th, 1),
               occupancy=(fx + fh) / max(tx + th, 1))
    if packed is not None:
        out.update(effective_macs=eff, packed_macs=total,
                   ops_reduction=total / max(eff, 1e-9))
    return out

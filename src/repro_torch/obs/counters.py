"""On-device serving counters, accumulated inside the scheduler's captured
decode chunk and read at its existing harvest.

The serving stack already keeps every per-token quantity the paper's
efficiency claims need on the device: the temporal-delta cache accumulates
fired-column counts (``nx`` / ``nh`` per layer), the speculative loop
keeps per-row ``rounds`` / ``drafted`` / ``accepted``, and the decode
chunk counts emitted tokens. This module folds them into ONE small float32
vector (a named slot layout, ``counter_names``) that the scheduler keeps
beside ``done`` / ``budget``:

- ``chunk_update`` adds to it in place at the end of the chunk's body, so
  on the card the adds are part of the captured graph (no extra launch
  from the host);
- each dispatch copies it beside the chunk's tokens, and the host reads
  that copy at the chunk's harvest: no extra device→host sync.

Slot semantics (float32: exact integers up to 2^24):

- ``decode_steps``, ``tokens``, ``spec_rounds``, ``spec_drafted``,
  ``spec_accepted`` are per-chunk deltas summed over the run (counters);
- ``fired_x_l{i}`` / ``fired_h_l{i}`` are GAUGES: the current cache's
  cumulative fired-column sums, re-read at each chunk's end. At drain they
  equal what ``occupancy_report`` recomputes from the same cache.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["BASE_COUNTERS", "counter_names", "zeros", "chunk_update",
           "harvest", "from_state", "fired_totals"]

BASE_COUNTERS = ("decode_steps", "tokens", "spec_rounds", "spec_drafted",
                 "spec_accepted")
_SPEC = (("rounds", "spec_rounds"), ("drafted", "spec_drafted"),
         ("accepted", "spec_accepted"))


def _num_delta_layers(model) -> int:
    if getattr(model, "delta", None) is None:
        return 0
    return getattr(getattr(model, "cfg", None), "num_layers", 0)


def counter_names(model) -> tuple:
    """Slot layout for ``model``: the base counters plus one
    ``fired_x_l{i}`` / ``fired_h_l{i}`` gauge pair per delta-gated
    layer."""
    names = list(BASE_COUNTERS)
    for i in range(_num_delta_layers(model)):
        names += [f"fired_x_l{i}", f"fired_h_l{i}"]
    return tuple(names)


def zeros(names, device="cpu") -> torch.Tensor:
    return torch.zeros((len(names),), dtype=torch.float32, device=device)


def chunk_update(names, counters: torch.Tensor, st: dict, steps: int):
    """Fold one decode chunk's state into ``counters`` IN PLACE (the
    scheduler calls it at the end of the chunk's body, so on the card it
    is part of the captured graph). Returns ``counters``.

    ``st`` holds ``emitted`` (B,) (this chunk's tokens); ``rounds`` /
    ``drafted`` / ``accepted`` (B,) on spec chunks (this chunk's
    increments); ``cache`` with per-layer ``nx`` / ``nh`` when the model
    is delta-gated.
    """
    idx = {n: i for i, n in enumerate(names)}
    counters[idx["decode_steps"]].add_(float(steps))
    counters[idx["tokens"]].add_(st["emitted"].sum(dtype=torch.float32))
    for key, slot in _SPEC:
        if key in st:
            counters[idx[slot]].add_(st[key].sum(dtype=torch.float32))
    if "fired_x_l0" in idx:
        for i, lp in enumerate(st["cache"]["layers"]):
            counters[idx[f"fired_x_l{i}"]].copy_(
                lp["nx"].sum(dtype=torch.float32))
            counters[idx[f"fired_h_l{i}"]].copy_(
                lp["nh"].sum(dtype=torch.float32))
    return counters


def harvest(names, values) -> dict:
    """Counter vector → {name: float} on the host. The scheduler calls it
    on the copy that rides an already-harvested chunk, so it waits for
    nothing new."""
    vals = np.asarray(torch.as_tensor(values).detach().cpu(), np.float64)
    return {n: float(v) for n, v in zip(names, vals)}


def from_state(model, state, *, steps: int) -> dict:
    """Counters for a LOCKSTEP ``ServeEngine.generate`` run, read from the
    decode loop's final state (``return_state=True``): one host read of
    quantities the run already produced."""
    names = counter_names(model)
    out = dict.fromkeys(names, 0.0)
    out["decode_steps"] = float(steps)
    out["tokens"] = float(state["emitted"].sum())
    for key, slot in _SPEC:
        if key in state:
            out[slot] = float(state[key].sum())
    if _num_delta_layers(model):
        for i, lp in enumerate(state["cache"]["layers"]):
            out[f"fired_x_l{i}"] = float(lp["nx"].sum(dtype=torch.float32))
            out[f"fired_h_l{i}"] = float(lp["nh"].sum(dtype=torch.float32))
    return out


def fired_totals(counters: dict) -> tuple[list, list]:
    """Per-layer ([fired_x...], [fired_h...]) lists from a harvested
    counter dict (empty lists when the run was not delta-gated)."""
    fx, fh = [], []
    i = 0
    while f"fired_x_l{i}" in counters:
        fx.append(counters[f"fired_x_l{i}"])
        fh.append(counters[f"fired_h_l{i}"])
        i += 1
    return fx, fh

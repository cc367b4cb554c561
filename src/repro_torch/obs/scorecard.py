"""Effective-GOPS scorecard: harvested counters × roofline bounds.

The paper's headline figure is *effective* throughput — dense-equivalent
ops per second, which sparsity multiplies without touching the clock
(Table 2: effective-throughput gain ≈ 1/(1−sparsity)). This module turns
one serve run's harvested counters (``obs.counters``) plus its packed
params into that figure and places it against the decode roofline:

- ``effective_gops``  = 2 · dense-equivalent recurrent-cell MACs/token ·
  achieved tok/s — the paper's effective-GOPS axis;
- ``achieved_gops``   = 2 · MACs actually executed / wall — packed MACs,
  further scaled by delta occupancy when fired-column counters are
  present (exactly ``occupancy_report``'s MAC weighting: a fired column
  of family F costs rows_F · K_F / N_F MACs);
- ``bound_toks_per_s`` = B · HBM_BW / weight-stream bytes — the
  memory-roofline decode bound (every decode step streams the packed
  recurrent weights once), at the H100's 3.35 TB/s (``repro_torch.hw``);
- ``bound_effective_gops`` / ``roofline_gap`` place the run against that
  bound on the same effective axis;
- ``bytes_per_token`` = weight-stream bytes (per lockstep row-step the
  whole packed cell streams once, amortized over the B slots decoding).

Accounting scope matches ``occupancy_report`` and the pack report:
recurrent-cell weights (W_x, W_h) only — embedding row gathers and the
LM head are excluded from both the MAC and the byte ledger on every
line, so ratios stay apples-to-apples.

The port of ``repro/obs/scorecard.py``: the same ledger over the port's
param trees (dense tensors, ``RowBalancedSparse`` and
``RowBalancedSparseQ8`` leaves) and ``obs.counters`` harvests, against
``repro_torch.hw``'s card; ``render`` names the card the run took.
"""
from __future__ import annotations

from .. import hw
from . import counters as _counters

__all__ = ["layer_geometry", "weight_stream_bytes", "build", "render"]


def _is_packed(leaf) -> bool:
    return hasattr(leaf, "K") and hasattr(leaf, "ncols")


def layer_geometry(params) -> list[dict]:
    """Per-layer MAC/shape ledger from an LSTM param tree (dense, packed,
    or q8-packed leaves): rows/ncols/K for W_x and W_h, plus the dense
    and packed MACs per token they imply (K = ncols when dense)."""
    out = []
    for lp in params["layers"]:
        entry = {}
        for fam, key in (("x", "w_x"), ("h", "w_h")):
            w = lp[key]
            if _is_packed(w):
                rows, ncols, k = w.rows, w.ncols, w.K
            else:
                rows, ncols = w.shape
                k = ncols
            entry[f"rows_{fam}"] = rows
            entry[f"ncols_{fam}"] = ncols
            entry[f"k_{fam}"] = k
        entry["dense_macs"] = (entry["rows_x"] * entry["ncols_x"]
                               + entry["rows_h"] * entry["ncols_h"])
        entry["packed_macs"] = (entry["rows_x"] * entry["k_x"]
                                + entry["rows_h"] * entry["k_h"])
        out.append(entry)
    return out


def weight_stream_bytes(params) -> int:
    """Bytes of recurrent-cell weights one decode step streams from HBM:
    packed leaves count values+indices (+scales), dense leaves their full
    array — the ``pack_report["packed_bytes"]`` figure, recomputed from
    the params actually being served."""
    total = 0
    for lp in params["layers"]:
        for key in ("w_x", "w_h"):
            w = lp[key]
            if hasattr(w, "memory_bytes"):
                total += int(w.memory_bytes()["total"])
            else:
                total += w.numel() * w.element_size()
    return total


def build(params, counters: dict, wall_s: float, *, batch: int = 1,
          bytes_per_step: int | None = None,
          step_sum: float | None = None) -> dict:
    """One serve run's scorecard.

    Parameters
    ----------
    params : pytree
        The params the run served (dense or packed — geometry and byte
        accounting adapt).
    counters : dict
        Harvested counter dict (``obs.counters.harvest``/``from_state``):
        ``tokens`` drives throughput; ``fired_*`` gauges, when present,
        scale executed MACs by the measured delta occupancy.
    wall_s : float
        Driver wall time over which ``counters`` accumulated.
    batch : int
        Lockstep width (slots) — scales the roofline bound: one weight
        stream serves all B rows' steps.
    bytes_per_step : int, optional
        Override the weight-stream byte estimate (e.g. a
        ``pack_report["packed_bytes"]`` that saw pre-padding shapes).
    step_sum : float, optional
        Total per-row steps the fired-column gauges accumulated over
        (``occupancy_report``'s basis: Σ over rows of prefill + decode
        steps — ``sched.slot_steps.sum()`` for the scheduler,
        B·(prompt+generated) for a lockstep run). Enables the occupancy
        lines; without it they are omitted rather than guessed.
    """
    geo = layer_geometry(params)
    dense_macs = sum(g["dense_macs"] for g in geo)
    packed_macs = sum(g["packed_macs"] for g in geo)
    tokens = float(counters.get("tokens", 0.0))
    steps = float(counters.get("decode_steps", 0.0))
    wall_s = max(float(wall_s), 1e-12)
    toks_per_s = tokens / wall_s

    fx, fh = _counters.fired_totals(counters)
    if fx:
        # delta-gated: MACs executed = Σ fired columns × that family's
        # per-column packed cost (occupancy_report's exact weighting)
        executed_macs = sum(
            fxl * g["rows_x"] * g["k_x"] / g["ncols_x"]
            + fhl * g["rows_h"] * g["k_h"] / g["ncols_h"]
            for fxl, fhl, g in zip(fx, fh, geo))
    else:
        executed_macs = tokens * packed_macs

    nbytes = int(bytes_per_step if bytes_per_step is not None
                 else weight_stream_bytes(params))
    bound_toks = batch * hw.HBM_BW / max(nbytes, 1)
    out = {
        "tokens": int(tokens),
        "decode_steps": int(steps),
        "wall_s": round(wall_s, 6),
        "toks_per_s": round(toks_per_s, 3),
        "dense_macs_per_token": int(dense_macs),
        "packed_macs_per_token": int(packed_macs),
        "executed_macs": round(executed_macs, 1),
        "achieved_gops": round(2.0 * executed_macs / wall_s / 1e9, 6),
        "effective_gops": round(2.0 * dense_macs * tokens / wall_s / 1e9, 6),
        "bytes_per_token": nbytes,
        "bound_toks_per_s": round(bound_toks, 1),
        "bound_effective_gops": round(2.0 * dense_macs * bound_toks / 1e9,
                                      3),
        "roofline_gap": round(bound_toks / max(toks_per_s, 1e-12), 2),
        "bound": "memory",
    }
    if counters.get("spec_drafted"):
        out["spec_acceptance_rate"] = round(
            counters["spec_accepted"] / counters["spec_drafted"], 4)
    if fx and step_sum:
        denom_x = sum(step_sum * g["ncols_x"] for g in geo)
        denom_h = sum(step_sum * g["ncols_h"] for g in geo)
        out["occupancy_x"] = round(sum(fx) / max(denom_x, 1), 4)
        out["occupancy_h"] = round(sum(fh) / max(denom_h, 1), 4)
    return out


def render(card: dict, device: str | None = None) -> str:
    """Human-readable scorecard block for launch.serve --scorecard;
    ``device`` names the card the run took (the bound is the H100's)."""
    lines = [
        "scorecard" + (f" on {device}" if device else "") + ":",
        f"  tokens {card['tokens']} in {card['wall_s']:.3f}s "
        f"-> {card['toks_per_s']:.1f} tok/s",
        f"  effective GOPS {card['effective_gops']:.3f} "
        f"(dense-equiv {card['dense_macs_per_token']} MACs/token)",
        f"  achieved GOPS {card['achieved_gops']:.3f} "
        f"(executed {card['executed_macs']:.3e} MACs)",
        f"  roofline bound {card['bound_toks_per_s']:.0f} tok/s at "
        f"{hw.HBM_BW / 1e12:.2f} TB/s ({hw.NAME}) "
        f"= {card['bound_effective_gops']:.1f} effective GOPS "
        f"({card['bound']}-bound, {card['bytes_per_token']} B/token) "
        f"-> gap {card['roofline_gap']:.1f}x",
    ]
    if "occupancy_x" in card:
        lines.append(f"  delta occupancy x={card['occupancy_x']:.1%} "
                     f"h={card['occupancy_h']:.1%}")
    if "spec_acceptance_rate" in card:
        lines.append(f"  spec acceptance "
                     f"{card['spec_acceptance_rate']:.1%}")
    return "\n".join(lines)

"""Mixture-of-Experts: top-k routing with per-group capacity dispatch.

The port of ``repro/models/moe.py``. The function is the reference's:
tokens are routed within groups of G = min(moe_group, S) tokens (G
decremented until it divides S); the router runs in float32 with the
softmax over the E experts; the top k are chosen by k argmax passes (ties
to the lowest index, slots in selection order); the gates are normalised
over the k chosen before any drop; each (token, slot) pair's rank within
its expert is a cumulative count in token-major, slot-minor order; pairs
at rank ≥ C are dropped and the remaining gates are not renormalised; the
Switch-style auxiliary loss is taken over the pre-drop choices.

The reference dispatches and combines with one-hot einsums (a form XLA's
partitioner shards). Here the kept pairs are gathered into an (E, groups ·
C, d) buffer at (expert, group, rank), the expert FFN runs batched over E
(``torch.bmm``: plain products, as the reference's einsums are, outside
any kernel), and the outputs are gathered back at the same places, scaled
by the gates and summed over the k slots in float32. Every shape is
static (no ``nonzero``, no size read from the data), so a decode step
runs inside a CUDA graph; the indices carry no gradient, as the
reference's ``stop_gradient`` ensures.
"""
from __future__ import annotations

import math

import torch

from .layers import PSpec, _act


def moe_defs(d_model: int, d_ff: int, num_experts: int, activation: str,
             dtype) -> dict:
    """The router (float32, d × E) and the experts' FFN weights, (E, d,
    ff) and (E, ff, d)."""
    up = PSpec((num_experts, d_model, d_ff), dtype=dtype,
               axes=("experts", "embed", "mlp"))
    d = {"router": PSpec((d_model, num_experts), dtype=torch.float32,
                         axes=("embed", "experts")),
         "w_up": up,
         "w_down": PSpec((num_experts, d_ff, d_model), dtype=dtype,
                         axes=("experts", "mlp", "embed"))}
    if activation.endswith("_glu"):
        d["w_gate"] = up
    return d


def capacity(seq_len: int, top_k: int, num_experts: int, cf: float) -> int:
    """Slots an expert takes from a group of ``seq_len`` tokens."""
    return max(4, int(math.ceil(seq_len * top_k / num_experts * cf)))


def routing_group(S: int, moe_group: int) -> int:
    """The routing group: min(moe_group, S), decremented until it divides
    S."""
    G = min(moe_group, S)
    while S % G:
        G -= 1
    return G


def topk_iterative(probs: torch.Tensor, K: int) -> torch.Tensor:
    """The k experts of each row of ``probs`` (..., E) by k argmax passes,
    each chosen entry lowered by 1e9 before the next pass: ties go to the
    lowest index and the slots keep the order of selection (which
    ``torch.topk`` does not promise for equal values). Returns (..., K)
    int64."""
    E = probs.shape[-1]
    experts = torch.arange(E, device=probs.device)
    p, ids = probs, []
    for _ in range(K):
        i = p.argmax(-1)
        ids.append(i)
        p = p - (i[..., None] == experts).to(p.dtype) * 1e9
    return torch.stack(ids, -1)


def route(p: dict, xg: torch.Tensor, *, num_experts: int, top_k: int,
          capacity_factor: float):
    """Routing of groups ``xg`` (N, G, d). Returns (ids (N, G, K) int64,
    gates (N, G, K) float32 normalised over the K, rank (N, G·K) of each
    pair within its expert in token-major, slot-minor order, C, aux): a
    pair is kept where rank < C."""
    N, G, _ = xg.shape
    E, K = num_experts, top_k
    C = capacity(G, K, E, capacity_factor)
    logits = torch.matmul(xg.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)                      # (N, G, E)
    ids = topk_iterative(probs.detach(), K)
    gates = probs.gather(-1, ids)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    experts = torch.arange(E, device=xg.device)
    # Switch-style load balancing, per group: mean prob x mean count
    chosen = (ids[..., None] == experts).float().sum(2)        # (N, G, E)
    aux = (probs.mean(1) * chosen.mean(1)).sum(-1).mean() * E
    onehot = (ids.reshape(N, G * K)[..., None] == experts).to(torch.int32)
    rank = ((onehot.cumsum(1) - 1) * onehot).sum(-1)           # (N, G·K)
    return ids, gates, rank, C, aux


def moe_apply(p: dict, x: torch.Tensor, *, num_experts: int, top_k: int,
              capacity_factor: float, activation: str,
              group_size: int = 1024, expert_range=None):
    """x (B, S, d) → (out (B, S, d) in x's dtype, aux loss, a float32
    scalar). ``group_size`` is the config's ``moe_group``.

    ``expert_range`` (e0, e1): a rank's experts under expert parallelism
    (``TensorParallel.moe``): ``p``'s FFN weights hold experts [e0, e1)
    only (its router all E columns, so the routing is the one-device
    one), the FFN runs on the pairs routed to them, and ``out`` is the
    float32 partial sum of their gated outputs (the other experts' pairs
    read 0), which the ranks sum before the cast."""
    B0, S0, d = x.shape
    G = routing_group(S0, group_size)
    xg = x.reshape(-1, G, d)
    N = xg.shape[0]
    E, K = num_experts, top_k
    ids, gates, rank, C, aux = route(p, xg, num_experts=E, top_k=K,
                                     capacity_factor=capacity_factor)
    dev = x.device
    # each pair's row of the (E, N, C) buffer; a dropped pair's is the
    # extra row E·N·C, which reads a zero token and is never read back
    group = torch.arange(N, device=dev)[:, None]
    slot = torch.where(rank < C,
                       (ids.reshape(N, G * K) * N + group) * C + rank,
                       E * N * C)
    token = (group * G + torch.arange(G * K, device=dev) // K)
    rows = torch.full((E * N * C + 1,), N * G, dtype=torch.long, device=dev)
    rows.scatter_(0, slot.reshape(-1), token.reshape(-1))
    e0, e1 = (0, E) if expert_range is None else expert_range
    lo, hi = e0 * N * C, e1 * N * C
    xz = torch.cat([xg.reshape(N * G, d), xg.new_zeros((1, d))])
    buf = xz[rows[lo:hi]].reshape(e1 - e0, N * C, d)
    if activation.endswith("_glu"):
        h = (_act(activation, torch.bmm(buf, p["w_gate"]))
             * torch.bmm(buf, p["w_up"]))
    else:
        h = _act(activation, torch.bmm(buf, p["w_up"]))
    y = torch.bmm(h, p["w_down"]).reshape(hi - lo, d)
    yz = torch.cat([y, y.new_zeros((1, d))])
    # a pair of another rank's experts (or dropped) reads the zero row
    mine = torch.where((slot >= lo) & (slot < hi), slot - lo, hi - lo)
    yk = yz[mine].reshape(N, G, K, d)
    # the gates in x's dtype, as the reference's combine mask holds them,
    # the products summed in float32 and rounded once
    out = (yk.float() * gates.to(x.dtype).float()[..., None]).sum(2)
    if expert_range is not None:
        return out.reshape(B0, S0, d), aux
    return out.to(x.dtype).reshape(B0, S0, d), aux

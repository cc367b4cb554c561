"""The analytic roofline: model FLOPs and HBM traffic of an (arch, shape)
step.

The port of the analytic half of ``repro/roofline.py`` (``model_flops``,
``analytic_hbm_bytes``, ``_attn_free``), formula for formula; over
``repro_torch.hw``'s rates they give a step's compute and memory times on
the card. The reference's other half reads compiled XLA HLO
(``parse_hlo`` through ``analyze_hlo``): while-loop trip counts, dot FLOPs
and collective wire bytes of a sharded program. One card runs no such
program and has no counterpart of it, so that half is not ported.
"""
from __future__ import annotations

__all__ = ["model_flops", "analytic_hbm_bytes"]


def model_flops(arch, shape) -> dict:
    """MODEL_FLOPS: 6·N·D for training (2·N·D inference) + attention terms.
    N = active params (MoE: routed active only), D = tokens processed."""
    from .models import build_model
    m = build_model(arch)
    n_total = m.param_count()
    # active params: replace expert count by experts_per_token
    if arch.moe:
        act = arch.with_(num_experts=arch.experts_per_token)
        n_active = build_model(act).param_count()
    else:
        n_active = n_total
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        tokens = B * S
        factor = 6.0
    elif shape.kind == "prefill":
        tokens = B * S
        factor = 2.0
    else:  # decode: one token per sequence
        tokens = B * 1
        factor = 2.0
    core = factor * n_active * tokens
    # attention score/value flops (not in 6ND): 2·2·B·S·ctx·H·Dh per layer
    attn_layers = sum(1 for k in arch.block_pattern if k.startswith("attn"))
    n_attn = (arch.num_layers * attn_layers / max(len(arch.block_pattern), 1)
              if not arch.encdec else arch.num_layers + (arch.enc_layers or 0))
    Dh, Hq = arch.head_dim, arch.num_heads
    if shape.kind == "decode":
        ctx = S
        attn = 2 * 2 * B * 1 * ctx * Hq * Dh * n_attn * (factor / 2.0)
    else:
        ctx = S / 2  # causal average
        attn = 2 * 2 * B * S * ctx * Hq * Dh * n_attn * (factor / 2.0)
    if arch.window:
        attn = min(attn, 2 * 2 * B * (S if shape.kind != "decode" else 1)
                   * arch.window * Hq * Dh * n_attn * (factor / 2.0))
    return dict(total=core + attn, core=core, attention=attn,
                n_params=n_total, n_active=n_active)


def analytic_hbm_bytes(arch, shape, chips: int, opt: bool = True) -> dict:
    """Per-chip HBM traffic per step (the reference's documented formula).

    train: weights read 2× (fwd+bwd) + grads written + Adam m,v read+write
           (fp32) + remat block-input activations written+read.
    prefill: weights 1× + kv cache write + activations stream.
    decode: weights 1× + KV cache read at current length + state r/w.
    kv_quant: int8 cache + per-(pos,head) f32 scale (1 + 4/head_dim B/elem).
    """
    from .models import build_model
    m = build_model(arch)
    n = m.param_count()
    B, S = shape.global_batch, shape.seq_len
    bytes_w = 2  # bf16 weights
    kv_bytes = (1.0 + 4.0 / arch.head_dim) if arch.kv_quant else bytes_w
    d = arch.d_model
    L = arch.num_layers + (arch.enc_layers if arch.encdec else 0)
    if shape.kind == "train":
        weights = n * bytes_w * 2                  # fwd + bwd read
        grads = n * 4
        optim = n * 4 * 4 if opt else 0            # m,v read+write fp32
        acts = L * B * S * d * bytes_w * 2          # remat block inputs w+r
        total = weights + grads + optim + acts
    elif shape.kind == "prefill":
        weights = n * bytes_w
        kv = (L * B * S * arch.num_kv_heads * arch.head_dim * 2 * kv_bytes
              if not _attn_free(arch) else 0)
        acts = L * B * S * d * bytes_w
        total = weights + kv + acts
    else:
        weights = n * bytes_w
        kv = (L * B * S * arch.num_kv_heads * arch.head_dim * 2 * kv_bytes
              if not _attn_free(arch) else
              B * arch.num_heads * arch.head_dim ** 2 * 4 * 2)
        if arch.window and not _attn_free(arch):
            kv = min(kv, L * B * arch.window * arch.num_kv_heads
                     * arch.head_dim * 2 * kv_bytes)
        total = weights + kv
    return dict(total_per_chip=total / chips, weights=weights / chips,
                global_total=total)


def _attn_free(arch) -> bool:
    return all(not k.startswith("attn") for k in arch.block_pattern) \
        and not arch.encdec


"""Architecture registry: one module per assigned arch + the paper's LSTMs."""
from .base import (ArchConfig, BRDSConfig, ShapeConfig, SHAPES, runnable,
                   get_arch, list_archs, register)
from . import (
    llava_next_34b,
    qwen3_moe_235b_a22b,
    granite_moe_1b_a400m,
    seamless_m4t_medium,
    recurrentgemma_9b,
    nemotron_4_340b,
    qwen3_0_6b,
    minitron_8b,
    llama3_2_3b,
    rwkv6_7b,
)

ALL = [
    llava_next_34b.CONFIG,
    qwen3_moe_235b_a22b.CONFIG,
    granite_moe_1b_a400m.CONFIG,
    seamless_m4t_medium.CONFIG,
    recurrentgemma_9b.CONFIG,
    nemotron_4_340b.CONFIG,
    qwen3_0_6b.CONFIG,
    minitron_8b.CONFIG,
    llama3_2_3b.CONFIG,
    rwkv6_7b.CONFIG,
]

ARCH_NAMES = [c.name for c in ALL]


def smoke_config(name: str) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests: few layers, small
    width/vocab/experts, short window — structure preserved."""
    full = get_arch(name)
    pat_len = len(full.block_pattern)
    return full.with_(
        num_layers=max(2 * pat_len, pat_len + 1),  # ≥1 period + remainder
        d_model=128,
        num_heads=4,
        num_kv_heads=min(full.num_kv_heads, 2) if full.num_kv_heads > 1 else 1,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        num_experts=min(full.num_experts, 8) if full.moe else 0,
        experts_per_token=min(full.experts_per_token, 2) if full.moe else 0,
        enc_layers=2 if full.encdec else 0,
        enc_len=64,
        num_patches=16 if full.num_patches else 0,
        window=32 if full.window else None,
        d_rnn=128 if full.d_rnn else 0,
        rwkv_chunk=16,
        grad_accum=1,
        block_q=64,
        block_kv=64,
        dtype="float32",
    )

"""qwen3-moe-235b-a22b [moe] — 94L d4096 64H (GQA kv=4) expert-ff1536
v151936, MoE 128 experts top-8, qk_norm. [hf:Qwen/Qwen3-30B-A3B; hf]
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,                  # per-expert intermediate size
    vocab_size=151936,
    norm="rmsnorm",
    activation="silu_glu",
    qk_norm=True,
    rope_theta=1000000.0,
    moe=True,
    num_experts=128,
    experts_per_token=8,
    capacity_factor=1.25,
    grad_accum=4,
))

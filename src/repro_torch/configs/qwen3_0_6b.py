"""qwen3-0.6b [dense] — 28L d1024 16H (GQA kv=8, head_dim 128 projected up)
ff3072 v151936, qk_norm. [hf:Qwen/Qwen3-8B; hf]
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    norm="rmsnorm",
    activation="silu_glu",
    qk_norm=True,
    rope_theta=1000000.0,
    layout="dp",   # ≤1.3B params: DP beats TP16 (EXPERIMENTS.md §Perf cell 1)
))

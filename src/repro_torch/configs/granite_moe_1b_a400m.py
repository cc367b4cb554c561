"""granite-moe-1b-a400m [moe] — 24L d1024 16H (GQA kv=8) expert-ff512
v49155, MoE 32 experts top-8. [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,                   # per-expert intermediate size
    vocab_size=49155,
    norm="rmsnorm",
    activation="silu_glu",
    rope_theta=10000.0,
    moe=True,
    num_experts=32,
    experts_per_token=8,
    capacity_factor=1.25,
    layout="dp",   # ≤1.3B params: DP beats TP16 (EXPERIMENTS.md §Perf cell 1)
))

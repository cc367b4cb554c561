"""llama3.2-3b [dense] — 28L d3072 24H (GQA kv=8) ff8192 v128256.
[hf:meta-llama/Llama-3.2-1B; unverified]
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama3.2-3b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=128256,
    norm="rmsnorm",
    activation="silu_glu",
    rope_theta=500000.0,
))

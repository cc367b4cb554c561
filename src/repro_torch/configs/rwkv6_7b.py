"""rwkv6-7b [ssm] — Finch: 32L d4096 attention-free, ff14336 v65536,
data-dependent decay linear attention (64 heads × 64 dims). Sub-quadratic →
runs long_500k. [arXiv:2404.05892; hf]
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,
    num_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    norm="layernorm",
    activation="sq_relu",       # rwkv channel-mix uses relu²
    block_pattern=("rwkv",),
    rwkv_chunk=128,
    subquadratic=True,
    grad_accum=2,
))

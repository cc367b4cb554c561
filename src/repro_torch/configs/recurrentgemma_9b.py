"""recurrentgemma-9b [hybrid] — 38L d4096 16H (MQA kv=1) ff12288 v256000.

RG-LRU + local attention in a 1:2 ratio: block pattern
(rec, rec, attn_local) × 12 periods + 2 remainder rec blocks = 38 layers,
window 2048. Sub-quadratic → runs long_500k. [arXiv:2402.19427; unverified]
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    norm="rmsnorm",
    activation="gelu_glu",
    rope_theta=10000.0,
    block_pattern=("rec", "rec", "attn_local"),
    window=2048,
    d_rnn=4096,
    conv_width=4,
    subquadratic=True,
    grad_accum=2,
))

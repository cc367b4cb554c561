"""seamless-m4t-medium [audio] — enc-dec, 12L each side, d1024 16H (kv=16)
ff4096 v256206. The audio frontend is a STUB: input_specs provides
precomputed frame embeddings (B, S_enc, d). train_4k splits the 4096-token
budget 2048 enc / 2048 dec; decode shapes use a 3072-frame encoder memory.
[arXiv:2308.11596; hf]
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,              # decoder layers
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    norm="layernorm",
    activation="gelu",
    rope_theta=10000.0,
    encdec=True,
    enc_layers=12,
    enc_len=3072,
    layout="dp",   # ≤1.3B params: DP beats TP16 (EXPERIMENTS.md §Perf cell 1)
))

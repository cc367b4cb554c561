"""llava-next-34b [vlm] — 60L d7168 56H (GQA kv=8) ff20480 v64000.

anyres tiling: the vision frontend is a STUB; input_specs provides
precomputed patch embeddings for 5 anyres tiles × 576 patches = 2880 slots
prepended to the text sequence. [hf:llava-hf/llava-v1.6-mistral-7b-hf;
unverified]
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    norm="rmsnorm",
    activation="silu_glu",
    rope_theta=500000.0,
    num_patches=2880,          # 5 anyres tiles × 576 patches
    pad_heads_to=64,           # TP padding: 56 heads ∤ model=16 (see base.py)
    grad_accum=4,
))

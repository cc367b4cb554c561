"""minitron-8b [dense] — 32L d4096 32H (GQA kv=8) ff16384 v256000,
pruned nemotron (squared-ReLU). [arXiv:2407.14679; hf]
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="minitron-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=256000,
    norm="layernorm",
    activation="sq_relu",
    rope_theta=10000.0,
    grad_accum=2,
))

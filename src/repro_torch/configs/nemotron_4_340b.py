"""nemotron-4-340b [dense] — 96L d18432 96H (GQA kv=8) ff73728 v256000,
squared-ReLU MLP, layernorm. [arXiv:2402.16819; unverified]
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab_size=256000,
    norm="layernorm",
    activation="sq_relu",
    rope_theta=10000.0,
    grad_accum=8,
))

"""Architecture + shape configuration dataclasses and the shape grid.

A copy of the reference's ``configs/base.py`` with ``torch_dtype`` in place
of ``jdtype``; the config modules beside it are data, copied as they are.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class BRDSConfig:
    """Row-balanced dual-ratio sparsity settings for a model.

    family A = feed-forward-ish weights (paper's W_x, pruned harder);
    family B = recurrent/attention-ish weights (paper's W_h, pruned softer).
    """
    enabled: bool = False
    overall_sparsity: float = 0.875       # paper's hardware evaluation point
    spar_a: float = 0.875                 # W_x-analogue ratio
    spar_b: float = 0.875                 # W_h-analogue ratio


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    activation: str = "silu_glu"      # silu_glu | gelu_glu | gelu | sq_relu
    qk_norm: bool = False
    rope_theta: float = 500000.0
    # block pattern, repeated over depth: attn | attn_local | rec | rwkv
    block_pattern: tuple = ("attn",)
    window: int | None = None         # local attention window
    # MoE
    moe: bool = False
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    moe_group: int = 1024             # GShard routing group size (tokens)
    # encoder-decoder (audio family)
    encdec: bool = False
    enc_layers: int = 0
    enc_len: int = 3072               # encoder memory length for decode shapes
    # VLM
    num_patches: int = 0              # patch-embed slots prepended to text
    # tensor-parallel head padding: store q/o projections with this many
    # heads (dummy heads are hard-masked → mathematically inert); needed
    # when num_heads doesn't divide the model axis AND the attention params
    # are too large to replicate (llava: 56 → 64).
    pad_heads_to: int = 0
    # RWKV / RG-LRU
    d_rnn: int = 0                    # defaults to d_model
    conv_width: int = 4
    rwkv_chunk: int = 128
    # capabilities
    subquadratic: bool = False        # can run long_500k
    # parallelism layout: 'tp' (model axis = tensor/expert parallel) or
    # 'dp' (model axis folded into data parallelism; small models)
    layout: str = "tp"
    kv_quant: bool = False            # int8 KV cache (+per-pos/head scales)
    # numerics / training system
    dtype: str = "bfloat16"
    remat: bool = True
    grad_accum: int = 1
    zero1: bool = True                # shard optimizer state over data axis
    grad_compression: bool = False    # int8 DP gradient compression
    brds: BRDSConfig = BRDSConfig()
    # attention blocking (dry-run-lowered online-softmax path)
    block_q: int = 512
    block_kv: int = 1024

    def with_(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16,
                "float32": torch.float32}[self.dtype]

    @property
    def rnn_width(self) -> int:
        return self.d_rnn or self.d_model


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                          # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def runnable(arch: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether an (arch × shape) cell is runnable, with a reason if not."""
    if shape.name == "long_500k" and not arch.subquadratic:
        return False, ("pure full-attention arch: 512k dense causal attention "
                       "is quadratic — skipped per DESIGN.md §4")
    return True, ""


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    from . import ALL  # noqa: F401  — populate registry
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    from . import ALL  # noqa: F401
    return sorted(_REGISTRY)

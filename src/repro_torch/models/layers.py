"""Parameter declarations and the layers of the LSTM and the transformer.

Params are nested dicts / lists of tensors. Structure is declared once as a
tree of ``PSpec`` (shape + init); ``init_params`` turns it into tensors.
The norms, RoPE, MLP and head follow ``repro/models/layers.py`` op for op:
norms and RoPE compute in float32 and cast back, and the head's product is
taken in the weights' dtype before the cast to float32.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class PSpec:
    """Declaration of one parameter tensor. ``axes`` names its logical
    axes (the reference's names: ``"batch"``, ``"lstm_hidden"``, ...),
    one per dimension, or is empty when nothing reads them."""
    shape: tuple
    init: str = "normal"             # normal | zeros | ones
    scale: float | None = None       # stddev override (default 1/sqrt(fan_in))
    dtype: torch.dtype = torch.float32
    axes: tuple = ()

    def __post_init__(self):
        if self.axes and len(self.axes) != len(self.shape):
            raise ValueError(f"axes {self.axes} do not name the "
                             f"{len(self.shape)} dims of {self.shape}")


def _default_scale(shape) -> float:
    # the reference's convention: fan_in is the second-to-last dim
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return 1.0 / math.sqrt(max(fan_in, 1))


def init_params(defs, generator: torch.Generator, device: torch.device,
                shardings=None):
    """Tensors for a PSpec tree. Normal draws come from ``generator`` in
    tree order — dict keys sorted, lists in order — on the generator's own
    device, and are then moved to ``device``: a seeded CPU generator gives
    the same weights on every device; a seeded CUDA generator gives other
    weights, made on the card (the fast way to billions of them).
    ``shardings`` (a matching tree of ``sharding.NamedSharding``s): each
    leaf, drawn whole as without them, is kept as this rank's piece (a
    DTensor) before the next is drawn, so no rank holds more than one
    whole leaf."""
    if isinstance(defs, dict):
        return {k: init_params(defs[k], generator, device,
                               None if shardings is None else shardings[k])
                for k in sorted(defs)}
    if isinstance(defs, (list, tuple)):
        return type(defs)(init_params(d, generator, device,
                                      None if shardings is None else sh)
                          for d, sh in zip(defs, shardings or [None] *
                                           len(defs)))
    d = defs
    if d.init == "zeros":
        a = torch.zeros(d.shape, dtype=d.dtype, device=device)
    elif d.init == "ones":
        a = torch.ones(d.shape, dtype=d.dtype, device=device)
    else:
        s = d.scale if d.scale is not None else _default_scale(d.shape)
        a = (torch.randn(d.shape, generator=generator, dtype=torch.float32,
                         device=generator.device) * s).to(device=device,
                                                          dtype=d.dtype)
    if shardings is None:
        return a
    from ..dist.collective_ops import distribute
    return distribute(a, shardings)


def abstract_params(defs, device="meta"):
    """Tensors of each PSpec's shape and dtype with no data: ``meta``
    tensors by default (the torch form of the reference's
    ``ShapeDtypeStruct``s); under a ``FakeTensorMode``, ``device="cuda"``
    gives fake card tensors. Nothing is allocated or drawn."""
    if isinstance(defs, dict):
        return {k: abstract_params(v, device) for k, v in defs.items()}
    if isinstance(defs, (list, tuple)):
        return type(defs)(abstract_params(v, device) for v in defs)
    return torch.empty(defs.shape, dtype=defs.dtype, device=device)


def param_axes(defs):
    """The tree of each PSpec's logical axes (``()`` where it names none)."""
    if isinstance(defs, dict):
        return {k: param_axes(v) for k, v in defs.items()}
    if isinstance(defs, (list, tuple)):
        return type(defs)(param_axes(v) for v in defs)
    return tuple(defs.axes)


def param_shapes(defs):
    """The tree of each PSpec's shape."""
    if isinstance(defs, dict):
        return {k: param_shapes(v) for k, v in defs.items()}
    if isinstance(defs, (list, tuple)):
        return type(defs)(param_shapes(v) for v in defs)
    return tuple(defs.shape)


def count_params(defs) -> int:
    if isinstance(defs, dict):
        return sum(count_params(v) for v in defs.values())
    if isinstance(defs, (list, tuple)):
        return sum(count_params(v) for v in defs)
    return math.prod(defs.shape)


def param_bytes(defs) -> int:
    """The bytes of every param of ``defs`` in its dtype."""
    if isinstance(defs, dict):
        return sum(param_bytes(v) for v in defs.values())
    if isinstance(defs, (list, tuple)):
        return sum(param_bytes(v) for v in defs)
    return math.prod(defs.shape) * defs.dtype.itemsize


def embed_apply(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens]


# ------------------------------------------------------------------ norms

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + w.float())).to(x.dtype)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps) * (1.0 + w.float()) + b.float()
    return y.to(x.dtype)


def norm_defs(kind: str, dim: int) -> dict:
    w = PSpec((dim,), init="zeros", dtype=torch.float32, axes=("embed",))
    if kind == "rmsnorm":
        return {"w": w}
    return {"w": w, "b": w}


def apply_norm(kind: str, p: dict, x: torch.Tensor) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, p["w"])
    return layernorm(x, p["w"], p["b"])


# ------------------------------------------------------------------ RoPE

def rope_freqs(half: int, theta: float, device=None) -> torch.Tensor:
    """theta ** (-arange(half) / half) in float32. The power is taken in
    float64 and rounded once: the correctly rounded table, which is what
    XLA's float32 pow gives (PyTorch's float32 pow misses the last bit on a
    few entries, an error that grows with the position)."""
    expo = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    return (theta ** expo.double()).float()


def rope_tables(positions: torch.Tensor, half: int, theta: float):
    """(cos, sin) of positions (..., S) times the frequency table, float32,
    shaped (..., S, 1, half) to broadcast over heads. One pair serves q
    and k of every layer at these positions."""
    ang = positions[..., None].float() * rope_freqs(half, theta,
                                                    positions.device)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Half rotation of x (..., S, H, D) by ``rope_tables``' (cos, sin), in
    float32, cast back to x's dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0):
    """Half rotation. x (..., S, H, D); positions (..., S), broadcast
    against x's leading dims."""
    return apply_rope(x, *rope_tables(positions, x.shape[-1] // 2, theta))


# ------------------------------------------------------------ projections

def pmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y = x @ w over the last dim of x; w (K, N) or (K, *N) flattened. A
    plain large product: ``torch.matmul``."""
    y = torch.matmul(x, w.reshape(w.shape[0], -1))
    return y.reshape(*x.shape[:-1], *w.shape[1:])


# ------------------------------------------------------------------ MLP

def mlp_defs(d_model: int, d_ff: int, activation: str, dtype) -> dict:
    up = PSpec((d_model, d_ff), dtype=dtype, axes=("embed", "mlp"))
    down = PSpec((d_ff, d_model), dtype=dtype, axes=("mlp", "embed"))
    if activation in ("silu_glu", "gelu_glu"):
        return {"w_gate": up, "w_up": up, "w_down": down}
    return {"w_up": up, "w_down": down}


def _act(activation: str, x: torch.Tensor) -> torch.Tensor:
    F = torch.nn.functional
    if activation.startswith("silu"):
        return F.silu(x)
    if activation.startswith("gelu"):
        return F.gelu(x, approximate="tanh")    # jax.nn.gelu's default
    if activation == "sq_relu":
        r = F.relu(x)
        return r * r
    if activation == "relu":
        return F.relu(x)
    raise ValueError(activation)


def mlp_apply(p: dict, x: torch.Tensor, activation: str) -> torch.Tensor:
    """x (..., d_model). BRDS masks are applied to the params beforehand."""
    if activation.endswith("_glu"):
        h = _act(activation, pmm(x, p["w_gate"])) * pmm(x, p["w_up"])
    else:
        h = _act(activation, pmm(x, p["w_up"]))
    return pmm(h, p["w_down"])


# ------------------------------------------------------------ embed, head

def pad_vocab(v: int, mult: int = 256) -> int:
    return ((v + mult - 1) // mult) * mult


def embed_defs(vocab_padded: int, d_model: int, dtype) -> dict:
    return {"table": PSpec((vocab_padded, d_model), scale=1.0, dtype=dtype,
                           axes=("vocab", "embed"))}


def logits_apply(p_head: dict, x: torch.Tensor, real_vocab: int):
    """x (..., d) @ head (d, Vp) → (..., Vp) float32, the pad columns at
    -1e30."""
    w = p_head["w"]
    logits = torch.matmul(x, w).float()
    if w.shape[-1] != real_vocab:
        pad = torch.arange(w.shape[-1], device=x.device) >= real_vocab
        logits = logits.masked_fill(pad, -1e30)
    return logits

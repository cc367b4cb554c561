"""CUDA kernel: blocked causal / windowed GQA flash attention forward
(``csrc/attention.cu``, B15).

q rows right-aligned to the kv end (q row i at position Sk - Sq + i),
online softmax in float32, key tiles that the masks leave dead skipped,
ragged edges masked in the kernel (no padding to tile multiples). q, k
and v are read and the output written through strides: the model passes
its (B, S, H, D) projections as (B, H, S, D) views and gets the output
back in that layout. bf16 operands run on the tensor cores (wgmma, p
split into three bf16 terms for P.V); float32 operands on a SIMT body.
Replaces ``repro/kernels/flash_attention.py::flash_attention``; the
function it computes is ``ref.flash_attention_ref``.
"""
from __future__ import annotations

import torch

from . import _build

DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (32, 64, 128, 192, 256)
# launches by body: "tensor_cores" (bf16) and "simt" (float32); each adds
# one beside ``LAUNCHES["flash_attention"]``
BODIES = {"tensor_cores": 0, "simt": 0}


def dtype_code(dtype: torch.dtype) -> int:
    return DTYPES.index(dtype)


def check_strided(t, name: str, ndim: int, device, dtype=None) -> None:
    """A CUDA tensor of ``ndim`` dims in fp32 or bf16 (``dtype`` when
    given) whose last dim is unit-stride and whose rows start on 16-byte
    boundaries (the kernels load 16 bytes at a time)."""
    _build.require(t, name, dtypes=DTYPES if dtype is None else (dtype,),
                   ndim=ndim, device=device, contiguous=False)
    es = t.element_size()
    if (t.stride(-1) != 1 or t.data_ptr() % 16
            or any(s * es % 16 for s in t.stride()[:-1])):
        raise ValueError(f"{name} must have a unit last stride and 16-byte "
                         f"aligned rows, got strides {t.stride()}")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None):
    """q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D), any strides with a unit last
    dim; fp32 or bf16, q/k/v alike. Returns (B, Hq, Sq, D) in q.dtype: a
    view of a (B, Sq, Hq, D) buffer. A row with no live key gives 0."""
    _build.refuse_autograd("flash_attention", q, k, v)
    dev = q.device
    check_strided(q, "q", 4, dev)
    check_strided(k, "k", 4, dev, q.dtype)
    check_strided(v, "v", 4, dev, q.dtype)
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if k.shape != (B, Hkv, Sk, D) or v.shape != k.shape or Hq % Hkv:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: want q (B, Hq, Sq, D), k/v "
                         "(B, Hkv, Sk, D) with Hkv dividing Hq")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    o = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=dev)
    lib = _build.load("attention")
    body = "tensor_cores" if q.dtype == torch.bfloat16 else "simt"
    fn = (lib.brds_flash_attention_bf16 if body == "tensor_cores"
          else lib.brds_flash_attention)
    err = fn(q.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
             k.data_ptr(), k.stride(0), k.stride(1), k.stride(2),
             v.data_ptr(), v.stride(0), v.stride(1), v.stride(2),
             o.data_ptr(), o.stride(0), o.stride(2), o.stride(1),
             B, Hq, Hkv, Sq, Sk, D, int(causal),
             0 if window is None else int(window), float(D ** -0.5),
             _build.stream(dev))
    _build.check(err, "flash_attention")
    _build.LAUNCHES["flash_attention"] += 1
    BODIES[body] += 1
    return o.transpose(1, 2)

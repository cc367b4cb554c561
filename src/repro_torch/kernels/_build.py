"""Build the CUDA sources under ``repro_torch/csrc`` and bind them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface under ``build/`` at the repository root,
at its first use in a process; the file name carries a hash of the sources
and flags, so an edited source rebuilds. ``ctypes`` binds the entry points,
with ``c_void_p`` for every pointer and for the stream. Each entry point
returns ``cudaGetLastError()`` and ``check`` raises on anything but 0.

Nothing here runs at import: the CPU tests import every module on a machine
without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import statistics
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Launch counts by kernel name: each wrapper adds one where it launches its
# kernel, and nowhere else (``chip_smoke.py`` reads them around the serve
# path to show it went through the kernels).
LAUNCHES = {"rb_dual_spmv": 0, "lstm_gates": 0, "fused_brds_lstm_step": 0,
            "delta_rb_dual_spmv": 0, "fused_brds_delta_lstm_step": 0,
            "rb_dual_parts_q8": 0, "fused_brds_lstm_step_q8": 0,
            "fused_brds_delta_lstm_step_q8": 0, "rb_spmv": 0,
            "rb_spmv_q8": 0, "delta_rb_spmv": 0, "fused_brds_lstm_scan": 0,
            "fused_brds_delta_lstm_scan": 0, "decode_attention": 0,
            "flash_attention": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong      # element strides
# C signatures of the entry points, by source name
SIGNATURES = {
    "rb_spmv": {"brds_rb_spmv": [_P, _P, _I, _I, _P, _I, _P, _I, _I, _I, _I,
                                 _I, _I, _I, _I, _P],
                "brds_rb_spmv_info": [_I, _I, _P],
                "brds_rb_dual_spmv": [_P, _P, _I, _I, _P, _I, _P, _P, _I, _I,
                                      _P, _I, _P, _P, _I, _I, _I, _I, _I, _I,
                                      _I, _I, _I, _I, _I, _P],
                "brds_rb_dual_spmv_info": [_I, _I, _P]},
    "lstm_gates": {"brds_lstm_gates": [_P, _P, _P, _P, _I, _P, _P, _P, _I, _I,
                                       _I, _I, _P, _F, _F, _F, _P],
                   "brds_lstm_gates_info": [_P]},
    "fused_step": {
        "brds_fused_lstm_step": [_P, _P, _I, _I, _P, _I, _P, _P, _I, _I, _P,
                                 _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                 _I, _I, _I, _I, _P, _F, _F, _F, _P],
        "brds_fused_lstm_step_info": [_I, _I, _P],
        "brds_fused_delta_lstm_step": [_P, _P, _I, _I, _P, _P, _I, _P, _P,
                                       _I, _I, _P, _P, _I, _P, _P, _P, _P,
                                       _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                       _I, _I, _I, _P, _F, _F, _F, _P],
        "brds_fused_delta_lstm_step_info": [_I, _I, _P],
        "brds_fused_lstm_step_q8": [_P, _P, _I, _I, _P, _P, _I, _P, _P, _I,
                                    _I, _P, _P, _I, _I, _P, _P, _P, _P, _I,
                                    _I, _I, _I, _I, _I, _I, _I, _I,
                                    _P, _F, _F, _F, _P],
        "brds_fused_lstm_step_q8_info": [_I, _I, _I, _I, _I, _P],
        "brds_fused_delta_lstm_step_q8": [_P, _P, _I, _I, _P, _P, _I, _P, _P,
                                          _I, _I, _P, _P, _I, _I, _P, _P, _P,
                                          _P, _P, _P, _I, _I, _I, _I, _I,
                                          _I, _I, _I, _I, _P, _F, _F, _F,
                                          _P]},
    "delta_rb_spmv": {
        "brds_delta_rb_spmv": [_P, _P, _I, _I, _P, _P, _I, _P, _I, _I, _I,
                               _I, _I, _I, _I, _I, _P],
        "brds_delta_rb_spmv_info": [_I, _I, _P],
        "brds_delta_rb_dual_spmv": [_P, _P, _I, _I, _P, _P, _I, _P, _P, _I,
                                    _I, _P, _P, _I, _P, _P, _I, _I, _I, _I,
                                    _I, _I, _I, _I, _I, _I, _I, _P],
        "brds_delta_rb_dual_spmv_info": [_I, _I, _P]},
    "rb_spmv_q8": {
        "brds_rb_spmv_q8": [_P, _P, _I, _I, _P, _P, _I, _I, _P, _I, _I, _I,
                            _I, _I, _I, _I, _I, _P],
        "brds_rb_dual_parts_q8": [_P, _P, _I, _I, _P, _P, _I, _P, _P, _I, _I,
                                  _P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _I,
                                  _I, _I, _I, _I, _I, _P],
        "brds_rb_spmv_q8_info": [_I, _I, _I, _I, _I, _P]},
    "fused_scan": {
        "brds_fused_lstm_scan": [_P, _P, _I, _I, _P, _I, _P, _P, _I, _I, _P,
                                 _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                 _I, _I, _I, _I, _P, _F, _F, _F, _P],
        "brds_fused_lstm_scan_info": [_I, _I, _I, _I, _I, _P],
        "brds_fused_delta_lstm_scan": [_P, _P, _I, _I, _P, _I, _P, _P, _I,
                                       _I, _P, _I, _P, _P, _P, _P, _P, _P,
                                       _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                       _F, _F, _I, _I, _I, _I, _I, _I, _P,
                                       _F, _F, _F, _P]},
    "attention": {
        "brds_decode_attention": [_P, _L, _L, _P, _L, _L, _L, _P, _L, _L, _L,
                                  _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                                  _I, _I, _I, _I, _P, _I, _P],
        "brds_decode_attention_info": [_I, _I, _I, _I, _P],
        "brds_flash_attention": [_P, _L, _L, _L, _P, _L, _L, _L, _P, _L, _L,
                                 _L, _P, _L, _L, _L, _I, _I, _I, _I, _I, _I,
                                 _I, _I, _F, _P],
        "brds_flash_attention_bf16": [_P, _L, _L, _L, _P, _L, _L, _L, _P, _L,
                                      _L, _L, _P, _L, _L, _L, _I, _I, _I, _I,
                                      _I, _I, _I, _I, _F, _P],
        "brds_flash_attention_bf16_smem": [_I, _I]},
}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# ptxas reports (registers, spills) of the builds made in this process
BUILD_LOG: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are compiled at "
                       "their first launch and need the CUDA toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.name == f"{name}.cu" or src.suffix == ".cuh":
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, target: Path):
    """Start one nvcc that writes ``target`` through a temporary file."""
    BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish(name: str, target: Path, proc, tmp: str) -> None:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(tmp, target)   # atomic: a concurrent builder sees all or none
    BUILD_LOG[name] = out


def _bind(name: str, target: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(target))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    _libs[name] = lib
    return lib


def build_all() -> dict[str, ctypes.CDLL]:
    """Build every source not yet built, one nvcc per source, all started
    together; returns the bound libraries."""
    with _lock:
        todo = {n: _target(n) for n in SIGNATURES if n not in _libs}
        running = {n: _start(n, t) for n, t in todo.items()
                   if not t.exists()}
        for n, (proc, tmp) in running.items():
            _finish(n, todo[n], proc, tmp)
        for n, t in todo.items():
            _bind(n, t)
        return dict(_libs)


def load(name: str) -> ctypes.CDLL:
    """The bound library of ``csrc/<name>.cu``; the first call builds every
    source (``build_all``)."""
    lib = _libs.get(name)
    return lib if lib is not None else build_all()[name]


def check(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {err} "
                           "(cudaError_t)")


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The card's SMs (cached: the launch plans ask at every launch)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def kernel_info(source: str, entry: str, args, grid: int,
                device: torch.device) -> dict:
    """One kernel instantiation's registers and local (spill) bytes a
    thread, static shared bytes and blocks an SM, from a ``*_info`` entry
    point of ``csrc/<source>.cu`` (``args`` pick the instantiation and its
    dynamic shared memory), and the waves a grid of ``grid`` blocks
    takes."""
    from .plan import waves
    out = (ctypes.c_int * 4)()
    check(getattr(load(source), entry)(*args, out), entry)
    regs, local, static, per_sm = list(out)
    return dict(registers=regs, local_bytes=local, static_smem=static,
                blocks_per_sm=per_sm,
                waves=waves(grid, per_sm, sm_count(device)) if per_sm
                else None)


def time_ms(fn, flush: torch.Tensor | None = None, reps: int = 30,
            clean: bool = False) -> float:
    """Median CUDA-event time (ms) of ``fn`` over ``reps`` runs, after one
    untimed run. With ``flush`` (a card buffer larger than the 50 MB L2),
    it is zeroed before each run, which evicts the packed weights that
    would otherwise stay cached across reruns, and leaves the L2 full of
    dirty lines that ``fn``'s reads then write back; with ``clean`` it is
    read instead, which leaves clean lines. A spin of about 1 ms on the
    card before each run lets the host enqueue ``fn`` before the card
    reaches the start event, so the time is the card's alone and not the
    wrapper's host overhead."""
    fn()
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.sum() if clean else flush.zero_()
        torch.cuda._sleep(2_000_000)
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def refuse_autograd(kernel: str, *tensors) -> None:
    """Raise when grad mode is on and an operand requires grad: the
    kernels have no backward, and an output they allocate carries no
    autograd history, so a gradient through one would be lost without a
    word. Checked first, wherever the operands lie."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel has no backward, and an operand "
            "requires grad; call it under torch.no_grad() on detached "
            "tensors, or train through the plain PyTorch path")


def require(t: torch.Tensor, name: str, *, dtypes, ndim: int,
            device: torch.device | None = None,
            contiguous: bool = True) -> None:
    """Raise unless ``t`` is a CUDA tensor of one of ``dtypes`` and ``ndim``
    dims (on ``device``, contiguous when asked)."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got one on "
                         f"{t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def require_aligned(t: torch.Tensor, name: str, align: int = 16) -> None:
    """Raise unless ``t``'s data starts on an ``align``-byte boundary (the
    kernels that load four packed entries at once)."""
    if t.data_ptr() % align:
        raise ValueError(f"{name} must start on a {align}-byte boundary "
                         f"(a view at an offset? pass a copy)")

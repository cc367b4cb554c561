#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi``), the torch / CUDA versions, and builds
   every CUDA kernel from ``src/repro_torch/csrc`` (one nvcc per source, all
   started together).
2. Kernels: calls each kernel's wrapper at the serve path's full-width
   shapes (lstm_ptb, B=8, int16 deltas), at a small shape (B=3, int8
   deltas, odd H: the fused kernel's partial last block) and at a wide one
   (B=12: the 16-accumulator tier; int32 deltas for W_x), holds it against
   its plain PyTorch version on the same inputs, holds the fused step
   bitwise against the chained kernels, and times the kernel, the plain
   version and the dense library call with L2 flushed.
3. Serve: full-width ``lstm_ptb`` (random weights from seed 0) pruned and
   packed by ``lstm_policy(0.75, 0.5)`` through ``ServeEngine``, greedy
   ``generate`` with B=8, prompt 32, gen 64 on the fused path (the
   default) and on the chained path (``fused=False``), the launch counts
   set to 0 just before each and read just after; then the same run on the
   plain versions (``backend="ref"``), with teacher-forced logits and
   greedy tokens compared.

Prints a ``{"kernels": [...]}`` line and, last, the device line. Exits
non-zero on any failure, and without a card.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
FP32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores
Z_TOL = 1e-4      # z sums up to 8299 products: warp-tree vs sequential order
CELL_TOL = 1e-5   # c, h: the cell's inputs differ by at most z's rounding
LOGIT_TOL = 1e-3  # 96 recurrent steps of z-level differences through the head
MARGIN = 1e-4     # greedy tokens may differ only below this top-2 margin
SERVE = dict(batch=8, prompt=32, gen=64)
RUNS = 5          # timed generate runs per path; median and range reported


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, flush, reps: int = 30) -> float:
    """Median CUDA-event time of ``fn`` with L2 flushed before each run:
    writing a buffer larger than the 50 MB L2 evicts the packed weights,
    which would otherwise stay cached across reruns and beat the HBM bound
    (the serve path reads them once per step, after the head's 60 MB)."""
    import torch
    fn()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound(nbytes: int, flops: int) -> tuple[float, str]:
    """Least time (ms) for the work: bytes over the memory rate vs float32
    operations over the peak rate, the larger of the two."""
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations"


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def packed_bytes(s) -> int:
    """Values and deltas of the logical rows: what a kernel must read
    (``pad_packed``'s zero rows are not)."""
    return s.rows * s.K * (s.values.element_size() + s.deltas.element_size())


def make_case(torch, device, *, B, X, H, spar_x, spar_h, seed):
    from repro_torch.core import pack_from_dense, pad_packed
    g = torch.Generator(device=device).manual_seed(seed)
    rand = lambda *shape, s=1.0: torch.randn(*shape, generator=g,
                                             device=device) * s
    wx, wh = rand(4 * H, X, s=X ** -0.5), rand(4 * H, H, s=H ** -0.5)
    sx = pad_packed(pack_from_dense(wx, spar_x))
    sh = pad_packed(pack_from_dense(wh, spar_h))
    return dict(B=B, X=X, H=H, sx=sx, sh=sh, x=rand(B, X), h=rand(B, H),
                c=rand(B, H), bias=rand(4 * H, s=0.1))


def check_kernels(torch, device, flush):
    """Phase 2: each kernel against its plain version; returns per-kernel
    records (errors, times, bounds)."""
    from repro_torch.core import unpack
    from repro_torch.kernels import ops
    rec = {n: dict(max_abs_err=0.0) for n in
           ("rb_dual_spmv", "lstm_gates", "fused_brds_lstm_step")}

    def err(name, a, b, tol, what):
        e = (a.float() - b.float()).abs().max().item()
        if not e <= tol:
            raise AssertionError(f"{name} {what}: max |kernel - plain| = "
                                 f"{e:.3e} > {tol:.0e}")
        rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], e)
        return e

    full = make_case(torch, device, B=SERVE["batch"], X=1500, H=1500,
                     spar_x=0.75, spar_h=0.5, seed=1)
    small = make_case(torch, device, B=3, X=100, H=97, spar_x=0.75,
                      spar_h=0.5, seed=2)
    wide = make_case(torch, device, B=12, X=33000, H=97, spar_x=0.75,
                     spar_h=0.5, seed=3)
    for tag, cs in (("full", full), ("small", small), ("wide", wide)):
        sx, sh, x, h, c, b, H = (cs[k] for k in
                                 ("sx", "sh", "x", "h", "c", "bias", "H"))
        log(f"[kernels] {tag}: B={cs['B']} X={cs['X']} H={H} R={sx.rows} "
            f"padded to {sx.values.shape[0]}, Kx={sx.K} Kh={sh.K}, deltas "
            f"{sx.deltas.dtype}/{sh.deltas.dtype}")
        z_k = ops.rb_dual_spmv(sx, x, sh, h, b, backend="cuda")
        z_r = ops.rb_dual_spmv(sx, x, sh, h, b, backend="ref")
        torch.cuda.synchronize()
        e = err("rb_dual_spmv", z_k, z_r, Z_TOL, tag)
        log(f"  rb_dual_spmv   max|z err| {e:.3e} (tol {Z_TOL:.0e}: sums "
            f"of {sx.K + sh.K} products in warp-tree vs sequential order)")
        zs = [z_r[:, i * H:(i + 1) * H] for i in range(4)]
        for pwl in (False, True):
            ck, hk = ops.lstm_gates(*zs, c, pwl=pwl, backend="cuda")
            cr, hr = ops.lstm_gates(*zs, c, pwl=pwl, backend="ref")
            e = max(err("lstm_gates", ck, cr, CELL_TOL, f"{tag} c"),
                    err("lstm_gates", hk, hr, CELL_TOL, f"{tag} h"))
            log(f"  lstm_gates     pwl={pwl!s:5} max|c,h err| {e:.3e} "
                f"(tol {CELL_TOL:.0e}: same z, libm vs CUDA expf/tanhf)")
            cf, hf = ops.fused_brds_lstm_step(sx, x, sh, h, b, c, pwl=pwl,
                                              backend="cuda")
            cc, hc = ops.brds_lstm_step(sx, x, sh, h, b, c, pwl=pwl,
                                        backend="cuda")
            cp, hp = ops.fused_brds_lstm_step(sx, x, sh, h, b, c, pwl=pwl,
                                              backend="ref")
            torch.cuda.synchronize()
            e = max(err("fused_brds_lstm_step", cf, cp, CELL_TOL,
                        f"{tag} c"),
                    err("fused_brds_lstm_step", hf, hp, CELL_TOL,
                        f"{tag} h"))
            if not (torch.equal(cf, cc) and torch.equal(hf, hc)):
                raise AssertionError(f"fused step is not bitwise equal to "
                                     f"the chained kernels ({tag}, pwl={pwl})")
            log(f"  fused step     pwl={pwl!s:5} max|c,h err| {e:.3e} "
                f"(tol {CELL_TOL:.0e}); bitwise equal to chained kernels")

    # times at the serve path's shapes
    sx, sh, x, h, c, b, H = (full[k] for k in
                             ("sx", "sh", "x", "h", "c", "bias", "H"))
    B = full["B"]
    wx, wh = unpack(sx), unpack(sh)
    wxT, whT = wx.T.contiguous(), wh.T.contiguous()
    z = ops.rb_dual_spmv(sx, x, sh, h, b, backend="ref")
    zs = [z[:, i * H:(i + 1) * H] for i in range(4)]
    weights = packed_bytes(sx) + packed_bytes(sh)
    flops = 2 * B * (sx.rows * sx.K + sh.rows * sh.K)

    def addmm_pair():
        torch.addmm(torch.addmm(b, x, wxT), h, whT)

    runs = {
        "rb_dual_spmv": (
            lambda: ops.rb_dual_spmv(sx, x, sh, h, b, backend="cuda"),
            lambda: ops.rb_dual_spmv(sx, x, sh, h, b, backend="ref"),
            addmm_pair,
            bound(weights + nbytes(x, h, b, z), flops)),
        "lstm_gates": (
            lambda: ops.lstm_gates(*zs, c, backend="cuda"),
            lambda: ops.lstm_gates(*zs, c, backend="ref"),
            None,
            bound(nbytes(*zs, c) + 2 * nbytes(c), 30 * B * H)),
        "fused_brds_lstm_step": (
            lambda: ops.fused_brds_lstm_step(sx, x, sh, h, b, c,
                                             backend="cuda"),
            lambda: ops.fused_brds_lstm_step(sx, x, sh, h, b, c,
                                             backend="ref"),
            addmm_pair,
            bound(weights + nbytes(x, h, c, b) + 2 * nbytes(c),
                  flops + 30 * B * H)),
    }
    for name, (kern, plain, lib, (bms, by)) in runs.items():
        r = rec[name]
        r["ms"] = time_ms(kern, flush)
        r["plain_ms"] = time_ms(plain, flush)
        r["library_ms"] = time_ms(lib, flush) if lib else None
        r["bound_ms"], r["bound_by"] = bms, by
        lib_s = "null" if lib is None else f"{r['library_ms']:.4f}"
        log(f"[time] {name:22} kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {lib_s} ms, bound "
            f"{bms * 1e3:.2f} us ({by}) — median of 30, L2 flushed")
    return rec


def teacher_forced(torch, model, params, seq):
    """Logits after each position of ``seq`` (B, T) through decode_step."""
    cache = model.init_cache(seq.shape[0], seq.shape[1], seq.device)
    out = []
    for t in range(seq.shape[1] - 1):
        logits, cache = model.decode_step(params, cache, seq[:, t:t + 1], t)
        out.append(logits[:, 0])
    return torch.stack(out, 1)


def timed_runs(torch, run) -> list[float]:
    """Host-clock seconds of ``RUNS`` calls of ``run``, each ended by a
    synchronize."""
    out = []
    for _ in range(RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def serve(torch, device):
    """Phase 3: full-width lstm_ptb greedy serving on the fused kernel and
    on the chained pair, then on the plain versions. Returns each kernel's
    launch count from the path that runs it."""
    from repro_torch.kernels import ops
    from repro_torch.models import LSTMModel, LSTM_CONFIGS
    from repro_torch.serving import ServeEngine
    from repro_torch.sparse import lstm_policy, use_backend
    cfg = LSTM_CONFIGS["lstm_ptb"]
    B, P, G = SERVE["batch"], SERVE["prompt"], SERVE["gen"]
    model = LSTMModel(cfg)
    params = model.init(torch.Generator().manual_seed(0), device)
    eng = ServeEngine(model, max_len=P + G, sparsity=lstm_policy(0.75, 0.5),
                      device=device)
    t0 = time.perf_counter()
    packed, report = eng.prepare(params)
    torch.cuda.synchronize()
    lp = packed["layers"][0]
    log(f"[serve] lstm_ptb X={cfg.input_size} H={cfg.hidden} "
        f"V={cfg.vocab_size} layers={cfg.num_layers}; prepare "
        f"{time.perf_counter() - t0:.2f}s: W_x {tuple(lp['w_x'].values.shape)}"
        f" {lp['w_x'].deltas.dtype}, W_h {tuple(lp['w_h'].values.shape)} "
        f"{lp['w_h'].deltas.dtype}, packed/dense bytes {report['ratio']:.4f}")
    tokens = torch.randint(0, cfg.vocab_size, (B, P),
                           generator=torch.Generator().manual_seed(1)
                           ).to(device)
    chained = ServeEngine(LSTMModel(cfg, fused=False), max_len=P + G,
                          device=device)
    want = (P + G) * cfg.num_layers
    paths = (("fused", eng, {"fused_brds_lstm_step": want,
                             "rb_dual_spmv": 0, "lstm_gates": 0}),
             ("chained", chained, {"fused_brds_lstm_step": 0,
                                   "rb_dual_spmv": want, "lstm_gates": want}))
    outs, launches = {}, {}
    for tag, e, expect in paths:
        for k in ops.LAUNCHES:
            ops.LAUNCHES[k] = 0
        out = e.generate(packed, tokens, G)
        torch.cuda.synchronize()
        got = dict(ops.LAUNCHES)
        log(f"[serve] launches on the {tag} path: {got} (expected {expect}: "
            f"(prompt + gen) x layers = {want} per kernel of the path)")
        if got != expect:
            raise AssertionError(f"{tag} path launched {got}, expected "
                                 f"{expect}")
        if out.shape != (B, G) or not bool(((out >= 0)
                                            & (out < cfg.vocab_size)).all()):
            raise AssertionError(f"bad tokens: shape {tuple(out.shape)}")
        launches.update({k: n for k, n in got.items() if expect[k]})
        outs[tag] = out
        dts = timed_runs(torch, lambda: e.generate(packed, tokens, G))
        med = statistics.median(dts)
        log(f"[serve] {tag} greedy B={B} prompt={P} gen={G}: median "
            f"{med:.4f}s of {RUNS} runs ({B * G / med:.1f} tok/s, prefill "
            f"included; range {min(dts):.4f}-{max(dts):.4f}s, "
            f"{B * G / max(dts):.1f}-{B * G / min(dts):.1f} tok/s)")
    if not torch.equal(outs["fused"], outs["chained"]):
        raise AssertionError("fused and chained serving gave other tokens")
    log("[serve] fused and chained tokens identical")
    out = outs["fused"]

    with use_backend("ref"):
        t0 = time.perf_counter()
        out_ref = eng.generate(packed, tokens, G)
        torch.cuda.synchronize()
        dt_ref = time.perf_counter() - t0
    log(f"[serve] same run on the plain versions: {dt_ref:.3f}s "
        f"({B * G / dt_ref:.1f} tok/s)")
    seq = torch.cat([tokens, out.to(tokens.dtype)], 1)
    lg_k = teacher_forced(torch, model, packed, seq)
    with use_backend("ref"):
        lg_r = teacher_forced(torch, model, packed, seq)
    if not bool(torch.isfinite(lg_k).all()):
        raise AssertionError("non-finite logits on the kernel path")
    dl = (lg_k - lg_r).abs().max().item()
    log(f"[serve] teacher-forced logits, kernels vs plain: max|diff| "
        f"{dl:.3e} (tol {LOGIT_TOL:.0e})")
    if not dl <= LOGIT_TOL:
        raise AssertionError(f"logits differ by {dl:.3e}")
    top2 = lg_r[:, P - 1:].topk(2, dim=-1).values      # steps 0..G-1
    margin = (top2[..., 0] - top2[..., 1]).amin(dim=0)
    low = (margin < MARGIN).nonzero()
    first = int(low[0]) if len(low) else G
    same = bool(torch.equal(out[:, :first], out_ref[:, :first]))
    log(f"[serve] greedy tokens kernels vs plain identical up to step "
        f"{first} (first step with a top-2 margin < {MARGIN:.0e}: "
        f"{'none' if first == G else first}; smallest margin "
        f"{margin.min().item():.3e}); full match "
        f"{bool(torch.equal(out, out_ref))}")
    if not same:
        raise AssertionError("greedy tokens differ before any small margin")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"built {len(_build.SIGNATURES)} CUDA sources in "
        f"{time.perf_counter() - t0:.1f}s (into {_build.BUILD})")
    for name, out in _build.BUILD_LOG.items():
        regs = [ln.split("ptxas info    :")[-1].strip()
                for ln in out.splitlines() if "registers" in ln]
        log(f"  {name}: {len(regs)} kernels, e.g. {regs[:1]}")

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    rec = check_kernels(torch, device, flush)
    launches = serve(torch, device)

    src = {"rb_dual_spmv": ("rb_spmv.cu", "src/repro/kernels/rb_spmv.py:86"),
           "lstm_gates": ("lstm_gates.cu",
                          "src/repro/kernels/lstm_gates.py:70"),
           "fused_brds_lstm_step": ("fused_step.cu",
                                    "src/repro/kernels/fused_step.py:158")}
    kernels = []
    for name, r in rec.items():
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/csrc/{src[name][0]}",
            replaces=src[name][1], launches=launches[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Phase profiles of the multi-token scans (``fused_brds_lstm_scan``,
``fused_brds_delta_lstm_scan``), the fused q8 and delta-q8 steps
(``fused_brds_lstm_step_q8``, ``fused_brds_delta_lstm_step_q8``) and their
dual SpMV
(``rb_dual_parts_q8``), the temporal-delta steps
(``fused_brds_delta_lstm_step``, ``delta_rb_dual_spmv``), the float steps
(``fused_brds_lstm_step``, ``rb_dual_spmv``), the chained float step's
pair (``rb_dual_spmv`` then ``lstm_gates``), the single-family float,
delta and q8 SpMVs (``rb_spmv``, ``delta_rb_spmv``, ``rb_spmv_q8``) and
decode attention (``decode_attention``) on the card, by variants that
each skip one phase or change one launch.

    PYTHONPATH=src python -m repro_torch.launch.profile_kernels [--steps 32]
        [--batch 8] [--width 1500]

A profiler's counters (stall reasons, L2 hit rates) are not readable on
every machine, so this times the public wrapper (CUDA events, median of
30, L2 flushed before each run by a 256 MB write and a ~1 ms spin:
``_build.time_ms``, as ``chip_smoke.py`` times) on lstm_ptb's shapes (X = H = ``--width``,
``lstm_policy(0.75, 0.5)``, int16 deltas, random weights from seed 0)
and on variants that hand the kernel an empty packed family (K = 0
entries a row, so the kernel skips that product; the outputs are then
wrong and unused):

- ``full``: Sx@xs[t] and Sh@h every step;
- ``no Sx``: the recurrent product alone;
- ``no Sh``: the input projection alone;
- ``neither``: the cell, h's exchange between blocks and the barriers;

each at T = ``--steps`` and at T = 1, and the slope (T vs 1) per step.
Beside them: the full scan with the L2 left warm, T launches of the
single-step kernel. ``neither``'s slope bounds a step's fixed cost
(barrier, exchange, cell) from above. The delta scan (Θ = 0: every column
fires) takes the same variants and the warm run; its ``neither`` still
runs the threshold pass over every step's x (and h0), so ``neither``
against the float scan's gives that pass and m's share. The fused q8
step (int8 and q1.11 codes of the same weights) takes the same four
variants: ``neither`` is
its activation staging, cells and launch (also after an L2 flush by a
read); and the full step with its
activation codes staged in the plan's permuted column order
(``plan.stage_pos``) and in plain column order, alternated twice. The
fused delta-q8 step on the same codes takes ``full`` and ``neither``,
and the dual SpMV ``full``, ``neither``, ``full`` with the L2 warm and the
columns staged in order, bitwise the full run (``profile_dual_q8``).
The fused delta step and the delta dual SpMV on the float weights
(``profile_delta``): ``full`` (every column fired), ``neither`` (both
families empty: the launch, m's read and write, the cells, the staging),
``none fired`` (every mask 0: the same bytes, no product that counts),
``full`` with the L2 left warm, and three layouts of the same step that
must give its bits: nothing staged, columns staged in order, and the
staging's one-column-a-thread form. The float step and dual SpMV
(``profile_float``): ``full``, ``neither``, ``full`` with the L2 warm,
the same three layouts and x alone misaligned (the staging's column form
for x only), bitwise the full run; and the float step at B=32. The
chained pair (``profile_pair``): the dual SpMV then the cell on its z in
one event window, the cell launched as a programmatic dependent (as the
serve loop launches it) and plainly, alternated twice, the two bitwise;
beside them each kernel alone, the cell both ways. The single-family
SpMVs on W_x and on W_h (``profile_single``), the float one, the delta
one (every column fired) and the q8 one on int8 and q1.11 codes
(``profile_single_q8``): ``full``, ``neither`` (K = 0), ``full`` with the
L2 warm, nothing staged and the columns in order, the last two bitwise
the full run.
Decode attention at the qwen3-0.6b serve shape: the full call, one slice
a pair, the length as a host constant, lengths of 1, the full call after
an L2 flush by a read, and the launch plan's slices x ring stages, beside
SDPA and an empty kernel (``profile_decode``). Prints one line per
variant and, last, a JSON object with every time.
"""
from __future__ import annotations

import argparse
import json
import subprocess
from contextlib import contextmanager, nullcontext
from dataclasses import replace

import torch

from .. import hw
from ..core import pack_from_dense, pad_packed
from ..kernels import decode_attention as kdec
from ..kernels import delta_rb_spmv as kdelta
from ..kernels import fused_scan as kscan
from ..kernels import fused_step as kstep
from ..kernels import rb_spmv as krb
from ..kernels import rb_spmv_q8 as kq8
from ..kernels._build import time_ms
from ..kernels.lstm_gates import lstm_gates as gates_kernel
from ..kernels.plan import Q8Plan, StreamPlan, staged_cols
from ..quant import parse_scheme, quantize, quantize_packed


def in_order(plan: Q8Plan, X: int, H: int, code_bytes: int) -> Q8Plan:
    """``plan`` (of an X-wide input and an H-wide state, codes of
    ``code_bytes``) with the activation codes staged in column order
    (``stage_pos`` at shift 0, the identity) instead of its
    permutation."""
    if not plan.staged:
        return plan
    vec = plan.nb * code_bytes
    sums = plan.smem - (plan.xpad + plan.hpad) * vec
    xpad = staged_cols(X, 0, plan.slot_bits)
    hpad = staged_cols(H, 0, plan.slot_bits)
    return replace(plan, shift_x=0, shift_h=0, xpad=xpad, hpad=hpad,
                   smem=(xpad + hpad) * vec + sums)


@contextmanager
def planned_as(splits: int, stages: int | None = None):
    """decode_attention launched with ``splits`` slices a (b, kv head) pair
    (the cluster size) and ``stages`` ring stages (default: the plan's)."""
    planned = kdec.decode_plan_for

    def plan_for(*a):
        p = planned(*a)
        st = p.stages if stages is None else stages
        return replace(p, splits=splits, stages=st,
                       smem=p.smem + (st - p.stages) * p.stage_bytes)
    kdec.decode_plan_for = plan_for
    try:
        yield
    finally:
        kdec.decode_plan_for = planned


def profile_decode(dev, flush) -> dict:
    """decode_attention (B14) at the qwen3-0.6b serve shape (B=8, 16 q / 8
    kv heads of 128, bf16, length 544 of a 1024-row cache, read through
    the model's strides): the full call; its sequence in one slice a
    (b, kv head) pair; every row's length given as a host constant (no
    read of ``lengths`` before the first K load); lengths of 1 (the fixed
    cost alone); and the full call after an L2 flush that reads instead of
    writes (no dirty lines to write back). Then the plan's two choices,
    slices (1, 2, 4, 8) x ring stages (2, 4, 6), each timed after a dirty
    flush, after a read flush, with the L2 warm, at lengths of 1 (warm),
    and as 28 calls on 28 layers' caches back to back (a decode step's
    B14 launches, a call's share); beside them SDPA and an empty kernel
    (``torch.zeros_like`` of q: the timing's floor)."""
    B, Hq, Hkv, S, D, L = 8, 16, 8, 1024, 128, 544
    g = torch.Generator(device=dev).manual_seed(1)
    mk = lambda *s: torch.randn(*s, generator=g, device=dev).to(
        torch.bfloat16)
    q = mk(B, 1, Hq, D)[:, 0]
    layers = [tuple(mk(B, S, Hkv, D).transpose(1, 2) for _ in range(2))
              for _ in range(28)]
    k, v = layers[0]
    n = torch.full((B,), L, dtype=torch.int32, device=dev)
    ones = torch.ones_like(n)
    run = lambda lengths=n, **kw: (
        lambda: kdec.decode_attention(q, k, v, lengths, **kw))
    live = 2 * B * Hkv * L * D * 2
    print(f"decode_attention B={B} heads {Hq}/{Hkv}x{D} bf16, length {L} "
          f"of {S}: {live / 1e6:.1f} MB of live K and V, byte bound "
          f"{live / hw.HBM_BW * 1e6:.2f} us; CUDA events, median of 30, L2 "
          "flushed", flush=True)
    out = {}
    for name, fn in (("full", run()), ("host length", run(fixed_length=L)),
                     ("lengths 1", run(ones))):
        out[f"decode {name}"] = dict(ms=time_ms(fn, flush))
    with planned_as(1):
        out["decode one slice"] = dict(ms=time_ms(run(), flush))
    out["decode full, clean flush"] = dict(ms=time_ms(run(), flush,
                                                      clean=True))
    for key, r in out.items():
        print(f"  {key:22} {r['ms']:.4f} ms", flush=True)

    def step():
        for kk, vv in layers:
            kdec.decode_attention(q, kk, vv, n)

    F = torch.nn.functional
    mask = (torch.arange(S, device=dev) < L)[None, None, None, :]
    fns = {"sdpa": lambda: F.scaled_dot_product_attention(
               q[:, :, None], k, v, attn_mask=mask, enable_gqa=True),
           "empty kernel": lambda: torch.zeros_like(q)}
    for splits in (1, 2, 4, 8):
        for stages in (2, 4, 6):
            fns[f"{splits} slices {stages} stages"] = (splits, stages)
    for key, fn in fns.items():
        with planned_as(*fn) if isinstance(fn, tuple) else nullcontext():
            f = run() if isinstance(fn, tuple) else fn
            r = dict(dirty=time_ms(f, flush),
                     read_flush=time_ms(f, flush, clean=True),
                     warm=time_ms(f))
            if isinstance(fn, tuple):
                r["length_1_warm"] = time_ms(run(ones))
                r["28_layers_a_call"] = time_ms(step, flush, reps=10) / 28
        out[f"decode {key}"] = r
        print(f"  decode {key:20} " + ", ".join(
            f"{name} {ms:.4f}" for name, ms in r.items()) + " ms",
              flush=True)
    return out


@contextmanager
def _planned_as(change, planners):
    """Each (module, name) of ``planners`` returning ``change(plan)``
    instead of its plan."""
    saved = [(mod, name, getattr(mod, name)) for mod, name in planners]
    for mod, name, planned in saved:
        setattr(mod, name, lambda *a, planned=planned, **k:
                change(planned(*a, **k)))
    try:
        yield
    finally:
        for mod, name, planned in saved:
            setattr(mod, name, planned)


def stream_planned_as(change):
    """The staged float kernels (B1, B3, B4, B5, B11, B6) launched on
    ``change(plan)`` instead of their plan."""
    return _planned_as(change, ((krb, "stream_plan_for"),
                                (krb, "single_plan_for"),
                                (kdelta, "stream_plan_for"),
                                (kdelta, "single_plan_for"),
                                (kstep, "stream_plan_for")))


def q8_planned_as(change):
    """The staged q8 kernels (B7, B8, B9, B10) launched on
    ``change(plan)`` instead of their plan."""
    return _planned_as(change, ((kq8, "q8_plan_for"),
                                (kq8, "single_q8_plan_for"),
                                (kstep, "q8_plan_for")))


def _gathered(p: StreamPlan) -> StreamPlan:
    return replace(p, stage_x=False, stage_h=False,
                   smem=4 * p.families * p.rows * p.nb)


def _in_order(p: StreamPlan, X: int, H: int) -> StreamPlan:
    xpad, hpad = (staged_cols(n, 0, p.slot_bits) for n in (X, H))
    return replace(p, shift_x=0, shift_h=0, xpad=xpad, hpad=hpad,
                   smem=(xpad + hpad + p.families * p.rows) * p.nb * 4)


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts 4 bytes past a 16-byte
    boundary (the staging then takes one column a thread)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view_as(t)
    out.copy_(t)
    return out


def _outputs(r) -> tuple:
    return r if isinstance(r, tuple) else (r,)


def _profile_staged(kernels: dict, variants: dict, flush,
                    planned_as=stream_planned_as) -> dict:
    """Times each staged kernel (name -> call(families, operands)) on each
    variant (name -> (families, operands, plan change, whether it must
    give the full run's bits)), and the full run with the L2 warm; a plan
    change goes through ``planned_as``."""
    out = {}
    for kname, call in kernels.items():
        times, want = {}, None
        for name, (fam, acts, change, same) in variants.items():
            def run(call=call, fam=fam, acts=acts):
                return call(fam, acts)
            with planned_as(change) if change else nullcontext():
                got = run()
                times[f"{kname} {name}"] = dict(ms=time_ms(run, flush))
            if name == "full":
                want = got
                times[f"{kname} full, L2 warm"] = dict(ms=time_ms(run))
            if same and not all(torch.equal(a, b) for a, b in zip(
                    _outputs(got), _outputs(want))):
                raise SystemExit(f"{kname} {name}: not the full run's bits")
        for key, r in times.items():
            print(f"  {key:32} {r['ms']:.4f} ms", flush=True)
        out.update(times)
    return out


def _families(sx, sh):
    """Both packed families as (values, deltas), and both emptied (K = 0
    entries a row: the kernel skips their products)."""
    full = [(s.values, s.deltas) for s in (sx, sh)]
    empty = [(v[:, :0].contiguous(), d[:, :0].contiguous()) for v, d in full]
    return full, empty


def profile_delta(sx, sh, B: int, bias, c0, rand, flush) -> dict:
    """The fused delta step (B5) and the delta dual SpMV (B4) on packed Sx,
    Sh with random deltas: ``full`` (every mask 1, the Θ = 0 serve
    path), ``neither`` (both families empty), ``none fired`` (every mask
    0), ``full`` with the L2 warm (no flush between runs), and the full
    step with nothing staged (both families gathered from global memory),
    with the columns staged in order (shift 0) and with d and f misaligned
    (the staging's one-column-a-thread form); the last three must give the
    full step's bits."""
    X, H = sx.ncols, sh.ncols
    dx, dh, m = rand(B, X, sc=0.5), rand(B, H, sc=0.3), rand(B, 4 * H)
    ones = (torch.ones_like(dx), torch.ones_like(dh))
    zeros = (torch.zeros_like(dx), torch.zeros_like(dh))
    full, empty = _families(sx, sh)
    fired = (dx, ones[0], dh, ones[1])
    odd = tuple(_misaligned(t) for t in fired)
    variants = {
        "full": (full, fired, None, False),
        "neither": (empty, fired, None, False),
        "none fired": (full, (dx, zeros[0], dh, zeros[1]), None, False),
        "gathered": (full, fired, _gathered, True),
        "columns in order": (full, fired, lambda p: _in_order(p, X, H),
                             True),
        "scalar staging": (full, odd, None, True)}
    kernels = {
        "fused delta step": lambda fam, a: kstep.fused_brds_delta_lstm_step(
            *fam[0], *a[:2], *fam[1], *a[2:], m, bias, c0),
        "delta dual spmv": lambda fam, a: kdelta.delta_rb_dual_spmv(
            *fam[0], *a[:2], *fam[1], *a[2:], m)}
    return _profile_staged(kernels, variants, flush)


def profile_float(sx, sh, x, h, bias, c0, rand, flush) -> dict:
    """The float step (B3) and the dual SpMV (B1) on packed Sx, Sh at x,
    h: ``full``, ``neither`` (both families empty: the launch, the
    staging, the epilogue and cells), ``full`` with the L2 warm, and the
    full run with nothing staged, with the columns staged in order, with
    x and h misaligned (the staging's one-column-a-thread form) and with x
    alone misaligned (an embedding row handed in as a slice); the last
    four must give the full run's bits. Then the float step at B=32 (two
    16-row tiles a launch)."""
    X, H = sx.ncols, sh.ncols
    full, empty = _families(sx, sh)
    acts = (x, h)
    variants = {
        "full": (full, acts, None, False),
        "neither": (empty, acts, None, False),
        "gathered": (full, acts, _gathered, True),
        "columns in order": (full, acts, lambda p: _in_order(p, X, H), True),
        "scalar staging": (full, (_misaligned(x), _misaligned(h)), None,
                           True),
        "x misaligned": (full, (_misaligned(x), h), None, True)}
    kernels = {
        "fused step": lambda fam, a: kstep.fused_brds_lstm_step(
            *fam[0], a[0], *fam[1], a[1], bias, c0),
        "dual spmv": lambda fam, a: krb.rb_dual_spmv(
            *fam[0], a[0], *fam[1], a[1], bias)}
    out = _profile_staged(kernels, variants, flush)
    x32, h32, c32 = rand(32, X), rand(32, H), rand(32, H)
    out["fused step B=32"] = dict(ms=time_ms(
        lambda: kstep.fused_brds_lstm_step(*full[0], x32, *full[1], h32,
                                           bias, c32), flush))
    print(f"  {'fused step B=32':32} {out['fused step B=32']['ms']:.4f} ms",
          flush=True)
    return out


def profile_dual_q8(qs, acts, flush) -> dict:
    """The dual SpMV rb_dual_parts_q8 (B7) on the q8 codes ``qs`` of Sx,
    Sh and the activation codes and scales ``acts`` (qx, sx, qh, sh):
    ``full``, ``neither`` (both families empty: the launch, the staging,
    the writes of zx and zh), ``full`` with the L2 warm, and the full run
    with the staged columns in order (shift 0), which must give its
    bits."""
    qx, sax, qh, sah = acts
    X, H, cb = qx.shape[1], qh.shape[1], qx.element_size()
    full, empty = _families(*qs)
    comb = (qs[0].scales * sax, qs[1].scales * sah)
    variants = {
        "full": (full, None, None, False),
        "neither": (empty, None, None, False),
        "columns in order": (full, None, lambda p: in_order(p, X, H, cb),
                             True)}
    kernels = {f"dual q8 {qs[0].scheme.name}": lambda fam, _:
               kq8.rb_dual_parts_q8(*fam[0], comb[0], qx, *fam[1], comb[1],
                                    qh, qs[0].rows)}
    return _profile_staged(kernels, variants, flush, q8_planned_as)


def profile_pair(sx, sh, x, h, bias, c0, flush) -> dict:
    """The chained float step's kernels (B1 then B2) on packed Sx, Sh at x,
    h: the pair in one event window (L2 flushed before it), B2 launched as
    a programmatic dependent of B1 (``pdl``, the serve loop's launch) and
    plainly (``plain``, after B1 has drained), alternated twice; the two
    must give the same c and h bits. Beside them B1 alone and B2 alone on
    B1's z, each way. Returns ms by name (median of 30)."""
    H = h.shape[1]

    def dual():
        return krb.rb_dual_spmv(sx.values, sx.deltas, x, sh.values,
                                sh.deltas, h, bias)

    def cell(z, pdl):
        return gates_kernel(*(z[:, i * H:(i + 1) * H] for i in range(4)), c0,
                            pdl=pdl)

    z = dual()
    out, got = {}, {}
    for rep in (1, 2):
        for way, pdl in (("pdl", True), ("plain", False)):
            def run(pdl=pdl):
                return cell(dual(), pdl)
            got[way] = run()
            out[f"pair {way} #{rep}"] = time_ms(run, flush)
    if not all(torch.equal(a, b) for a, b in zip(got["pdl"], got["plain"])):
        raise SystemExit("pair: the programmatic launch changed the cell's "
                         "bits")
    out["dual spmv alone"] = time_ms(dual, flush)
    for way, pdl in (("pdl", True), ("plain", False)):
        out[f"cell alone {way}"] = time_ms(lambda pdl=pdl: cell(z, pdl), flush)
    for key, ms in out.items():
        print(f"  {key:32} {ms:.4f} ms", flush=True)
    return out


def _q8_gathered(p: Q8Plan) -> Q8Plan:
    """A q8 SpMV's plan (B7, B10) with the codes gathered from global
    memory: its shared memory holds the sums alone."""
    return replace(p, staged=False, smem=4 * p.families * p.rows * p.nb)


def profile_single_q8(qs, acts, flush) -> dict:
    """The single-family q8 SpMV rb_spmv_q8 (B10) on the q8 codes ``qs``
    of W_x at qx and of W_h at qh (``acts``: qx, sx, qh, sh): ``full``,
    ``neither`` (K = 0: the launch, the staging, the writes of y), ``full``
    with the L2 warm, and the full run with nothing staged and with the
    staged columns in order, both of which must give its bits."""
    out = {}
    for fam, s, q, sa in (("W_x", qs[0], acts[0], acts[1]),
                          ("W_h", qs[1], acts[2], acts[3])):
        n, cb = q.shape[1], q.element_size()
        full = (s.values, s.deltas)
        empty = tuple(t[:, :0].contiguous() for t in full)
        comb = s.scales * sa
        variants = {
            "full": (full, None, None, False),
            "neither": (empty, None, None, False),
            "gathered": (full, None, _q8_gathered, True),
            "columns in order": (full, None,
                                 lambda p, n=n, cb=cb: in_order(p, n, 0, cb),
                                 True)}
        kernels = {f"rb_spmv_q8 {s.scheme.name} {fam}": lambda f, _, q=q,
                   comb=comb, R=s.rows: kq8.rb_spmv_q8(*f, comb, q, R)}
        out.update(_profile_staged(kernels, variants, flush, q8_planned_as))
    return out


def profile_single(sx, sh, x, h, flush, masks=None) -> dict:
    """The single-family SpMV rb_spmv (B11) on W_x at x and on W_h at h,
    or, given ``masks`` (fx, fh), delta_rb_spmv (B6) with x and h as the
    deltas: ``full``, ``neither`` (K = 0: the launch, the staging, the
    writes of y), ``full`` with the L2 warm, and the full run with nothing
    staged and with the columns staged in order, both of which must give
    its bits."""
    out = {}
    for i, (fam, s, v) in enumerate((("W_x", sx, x), ("W_h", sh, h))):
        n = v.shape[1]
        full = (s.values, s.deltas)
        empty = tuple(t[:, :0].contiguous() for t in full)
        variants = {
            "full": (full, v, None, False),
            "neither": (empty, v, None, False),
            "gathered": (full, v, _gathered, True),
            "columns in order": (full, v, lambda p, n=n: _in_order(p, n, 0),
                                 True)}
        if masks is None:
            kernels = {f"rb_spmv {fam}": lambda f, a, R=s.rows:
                       krb.rb_spmv(*f, a, R)}
        else:
            kernels = {f"delta_rb_spmv {fam}": lambda f, a, R=s.rows,
                       m=masks[i]: kdelta.delta_rb_spmv(*f, a, m, R)}
        out.update(_profile_staged(kernels, variants, flush))
    return out


def profile_scans(sx, sh, xs, h0, c0, bias, rand, flush) -> dict:
    """The float scan (B12) and the delta scan (B13, Θ = 0, random
    references and m) with both packed families, with one of them empty
    (K = 0 entries a row) or both, each at T = len(xs) and at T = 1, the
    slope a step; the full scans with the L2 warm; and T launches of the
    float single-step kernel."""
    T, B, W = xs.shape
    fams = {"full": (sx, sh), "no Sx": (None, sh), "no Sh": (sx, None),
            "neither": (None, None)}
    refs = (rand(B, W), rand(B, W), rand(B, 4 * W))   # x_ref0, h_ref0, m0

    def packed(s, like):
        if s is not None:
            return s.values, s.deltas
        return like.values[:, :0].contiguous(), like.deltas[:, :0].contiguous()

    def scan(kind, fx, fh, steps):
        vx, dx = packed(fx, sx)
        vh, dh = packed(fh, sh)
        if kind == "scan":
            return lambda: kscan.fused_brds_lstm_scan(
                vx, dx, xs[:steps], vh, dh, h0, bias, c0)
        return lambda: kscan.fused_brds_delta_lstm_scan(
            vx, dx, xs[:steps], vh, dh, h0, c0, *refs, bias, theta_x=0.0,
            theta_h=0.0)

    out = {}
    for kind in ("scan", "delta scan"):
        print(f"{kind} X=H={W}, B={B}, Kx={sx.K}, Kh={sh.K}, deltas "
              f"{sx.deltas.dtype}; CUDA events, median of 30, L2 flushed",
              flush=True)
        pre = "" if kind == "scan" else "delta "
        for name, (fx, fh) in fams.items():
            tT = time_ms(scan(kind, fx, fh, T), flush)
            t1 = time_ms(scan(kind, fx, fh, 1), flush)
            out[pre + name] = dict(ms=tT, ms_T1=t1,
                                   step_us=(tT - t1) / (T - 1) * 1e3)
            print(f"  {name:8} T={T} {tT:.4f} ms, T=1 {t1:.4f} ms, "
                  f"{out[pre + name]['step_us']:.2f} us a step", flush=True)
        key = pre + "full, L2 warm"
        out[key] = dict(ms=time_ms(scan(kind, sx, sh, T)))
        print(f"  full, L2 warm (no flush) {out[key]['ms']:.4f} ms",
              flush=True)
    d, f = out["delta neither"], out["neither"]
    print(f"  delta neither - neither: T={T} {d['ms'] - f['ms']:.4f} ms, T=1 "
          f"{d['ms_T1'] - f['ms_T1']:.4f} ms (the threshold pass, m)",
          flush=True)

    def steps():
        c, h = c0, h0
        for x in xs:
            c, h = kstep.fused_brds_lstm_step(sx.values, sx.deltas, x,
                                              sh.values, sh.deltas, h, bias,
                                              c)
    out[f"{T} single steps"] = dict(ms=time_ms(steps, flush))
    print(f"  {T} launches of the single-step kernel "
          f"{out[f'{T} single steps']['ms']:.4f} ms", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--width", type=int, default=1500)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_kernels: no CUDA device")
    dev = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    T, B, W = args.steps, args.batch, args.width
    g = torch.Generator(device=dev).manual_seed(0)
    rand = lambda *s, sc=1.0: torch.randn(*s, generator=g, device=dev) * sc
    sx = pad_packed(pack_from_dense(rand(4 * W, W, sc=W ** -0.5), 0.75))
    sh = pad_packed(pack_from_dense(rand(4 * W, W, sc=W ** -0.5), 0.5))
    xs, h0, c0 = rand(T, B, W), rand(B, W), rand(B, W)
    bias = rand(4 * W, sc=0.1)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    out = profile_scans(sx, sh, xs, h0, c0, bias, rand, flush)
    fams = {"full": (sx, sh), "no Sx": (None, sh), "no Sh": (sx, None),
            "neither": (None, None)}
    for spec in ("int8", "q1.11"):
        scheme = parse_scheme(spec)
        qs = [pad_packed(quantize_packed(s, spec)) for s in (sx, sh)]
        acts = []
        for v in (xs[0], h0):
            sa = scheme.act_scale(float(v.abs().max()) / scheme.qmax)
            acts += [quantize(v, sa, scheme), sa]
        for name, (fx, fh) in fams.items():
            fam = [(q.values, q.deltas) if keep else
                   (q.values[:, :0].contiguous(), q.deltas[:, :0].contiguous())
                   for q, keep in zip(qs, (fx is not None, fh is not None))]

            def step(fam=fam):
                kstep.fused_brds_lstm_step_q8(
                    *fam[0], qs[0].scales * acts[1], acts[0], *fam[1],
                    qs[1].scales * acts[3], acts[2], bias, c0)
            key = f"q8 {spec} {name}"
            out[key] = dict(ms=time_ms(step, flush))
            print(f"  fused q8 step {spec:5} {name:8} {out[key]['ms']:.4f} ms",
                  flush=True)
            if name == "neither":   # no dirty lines to write back
                key = f"q8 {spec} neither, read flush"
                out[key] = dict(ms=time_ms(step, flush, clean=True))
                print(f"  fused q8 step {spec:5} neither, read flush "
                      f"{out[key]['ms']:.4f} ms", flush=True)
        # the staged columns' order: the plan's stage_pos permutation
        # against columns in order (shift 0), alternated twice; the two
        # give the same bits (integer sums)
        full = [(q.values, q.deltas) for q in qs]

        def step_full():
            return kstep.fused_brds_lstm_step_q8(
                *full[0], qs[0].scales * acts[1], acts[0], *full[1],
                qs[1].scales * acts[3], acts[2], bias, c0)

        got = {}
        for rep in (1, 2):
            for order in ("permuted", "in order"):
                with (nullcontext() if order == "permuted" else
                      q8_planned_as(lambda p: in_order(
                          p, W, W, qs[0].values.element_size()))):
                    got[order] = step_full()
                    key = f"q8 {spec} full, columns {order} #{rep}"
                    out[key] = dict(ms=time_ms(step_full, flush))
                print(f"  fused q8 step {spec:5} full, staged columns "
                      f"{order:8} (run {rep}) {out[key]['ms']:.4f} ms",
                      flush=True)
        if not all(torch.equal(a, b) for a, b in zip(got["permuted"],
                                                     got["in order"])):
            raise SystemExit(f"q8 {spec}: the staging orders disagree")
        # the fused delta-q8 step (B9) on the same codes taken as the codes
        # of the masked deltas, with a partial-sum memory m: full and
        # neither (its staging, m's update, the cells and the launch)
        m = rand(B, 4 * W)
        for name in ("full", "neither"):
            fam = [(q.values, q.deltas) if name == "full" else
                   (q.values[:, :0].contiguous(), q.deltas[:, :0].contiguous())
                   for q in qs]

            def dstep(fam=fam):
                kstep.fused_brds_delta_lstm_step_q8(
                    *fam[0], qs[0].scales * acts[1], acts[0], *fam[1],
                    qs[1].scales * acts[3], acts[2], m, bias, c0)
            key = f"delta q8 {spec} {name}"
            out[key] = dict(ms=time_ms(dstep, flush))
            print(f"  fused delta-q8 step {spec:5} {name:8} "
                  f"{out[key]['ms']:.4f} ms", flush=True)
        out.update(profile_dual_q8(qs, acts, flush))
        out.update(profile_single_q8(qs, acts, flush))
    print(f"delta steps X=H={W}, B={B}, Kx={sx.K}, Kh={sh.K}; CUDA events, "
          "median of 30, L2 flushed", flush=True)
    out.update(profile_delta(sx, sh, B, bias, c0, rand, flush))
    print(f"float steps X=H={W}, B={B}, Kx={sx.K}, Kh={sh.K}; CUDA events, "
          "median of 30, L2 flushed", flush=True)
    out.update(profile_float(sx, sh, xs[0], h0, bias, c0, rand, flush))
    print("chained float pair (rb_dual_spmv then lstm_gates); CUDA events, "
          "median of 30, L2 flushed", flush=True)
    out.update(profile_pair(sx, sh, xs[0], h0, bias, c0, flush))
    print(f"single-family SpMV X=H={W}, B={B}, Kx={sx.K}, Kh={sh.K}; CUDA "
          "events, median of 30, L2 flushed", flush=True)
    out.update(profile_single(sx, sh, xs[0], h0, flush))
    masks = tuple(torch.ones_like(v) for v in (xs[0], h0))
    out.update(profile_single(sx, sh, xs[0], h0, flush, masks))
    out.update(profile_decode(dev, flush))
    print(json.dumps({"card": card, "T": T, "B": B, "width": W,
                      "times": out}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

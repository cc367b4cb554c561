#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi``), the torch / CUDA versions, and builds
   every CUDA kernel from ``src/repro_torch/csrc`` (one nvcc per source, all
   started together); for the redesigned float and delta scans, fused
   q8, delta-q8, float and float delta steps, float, delta and q8 dual
   SpMVs, single-family float, delta and q8 SpMVs and the LSTM cell at
   the serve tier and decode attention at qwen3-0.6b's decode shape,
   prints ptxas's registers and spills, the local bytes, shared memory,
   blocks an SM and waves at the launch's grid (decode: its cluster size
   too; the cell: whether its block fits on an SM beside the float dual
   SpMV's, which it follows as a programmatic dependent), and fails on a
   spill, a local array or (but for decode) a second wave; and the same
   for B15's tensor-core body and B14 at recurrentgemma-9b's local
   attention (head_dim 256, 16 q heads on one kv head), failing also on
   shared memory past a block's 227 KB, and at the bodies the rest of the
   zoo launches (``occupancy_zoo``: head_dim 64 and 128, one or two
   warpgroups, one, two or four q heads a block).
2. Kernels: calls each kernel's wrapper at the serve path's full-width
   shapes (lstm_ptb, B=8, int16 deltas), at a small shape (B=3, int8
   deltas, odd H: the fused kernels' partial last block), at a wide one
   (B=12: the 16-accumulator tier; int32 deltas for W_x; too wide for the
   float scan and the q8 step to stage x in shared memory) and at a tall
   one (B=12, H=4000: too wide for the float scan and the staged float
   kernels to stage h; the float, float delta and q8 pairs and the
   single-family kernels once more at X=70000, past the 65535 columns the
   float kernels' packed column scans take), holds
   it against its plain PyTorch version on the same inputs, holds each
   fused step bitwise against its chained kernels, and times the kernel,
   the plain version and the dense library call with L2 flushed. The float kernels
   (rb_dual_spmv, lstm_gates, fused step), the temporal-delta ones
   (delta_rb_dual_spmv, fused delta step, delta_rb_spmv) at a fired share
   of about 50% and at 100%, the quantized ones (rb_dual_parts_q8, fused
   q8 step, rb_spmv_q8: staged, and gathered at the wide shapes) with int8
   and with q1.11 (int16) codes, the fused
   delta-q8 step on both code types and fired shares (and at B=1, 16 and
   64, as the fused q8 step and the float and float delta pairs), and the
   single-family float rb_spmv, whose two sums plus the bias must equal
   rb_dual_spmv bit for bit, as m + delta_rb_spmv(Sx) + delta_rb_spmv(Sh)
   must equal delta_rb_dual_spmv; the q8 partial sums, rb_spmv_q8 and the
   fused delta-q8 step's m' must equal the plain version's exactly. The
   multi-token scans over T=32 steps (the serve prompt), float and
   temporal delta (Θ=0 and 0.05), must be bitwise equal to T launches of
   their single-step kernels (the delta one after T thresholds in
   PyTorch), with PWL off and on; they are timed beside those T launches
   and, for the float scan, one cuDNN LSTM call on the dense weights.
   The chained float step's pair, rb_dual_spmv then lstm_gates, is timed
   in one event window with lstm_gates launched as a programmatic
   dependent and plainly, alternated, the two bitwise equal.
   At B=64 (full width) every row-balanced kernel and both scans run once
   more: bitwise equal to their four 16-row tiles (the kernels tile the
   batch inside one launch; the scans take one launch a tile) and within
   tolerance of the plain versions.
3. Serve: full-width ``lstm_ptb`` (random weights from seed 0) pruned and
   packed by ``lstm_policy(0.75, 0.5)`` through ``ServeEngine``, greedy
   ``generate`` with B=8, prompt 32, gen 64, the launch counts set to 0
   just before each path and read just after: packed float fused (the
   default) and chained; temporal delta at Θ=0 fused and chained and at
   Θ=0.05 (occupancy printed); int8 calibrated on a prompt-shaped batch,
   fused and chained; q1.11 fused; and Θ=0 delta with int8, fused and
   chained. Each mode's teacher-forced logits and greedy tokens are held
   against the same run on the plain versions (``backend="ref"``), fused
   against chained tokens, and Θ=0 delta tokens against the packed float
   ones. Then packed float fused at B=32 (two batch tiles a launch), whose
   first 8 rows repeat the B=8 prompts and must give the B=8 tokens.
4. Speculative serve: the same packed lstm_ptb target, greedy, B=8,
   prompt 32, gen 64, ``spec_k`` 4, with three drafts (the target's own
   packed params; ``lstm_imdb`` at its published width rebound to the
   vocabulary, packed, weights from seed 7; the target's weights with
   Θ=0 temporal delta), each generating the target-only greedy tokens,
   with its launch counts set to 0 just before and read just after (the
   scan kernel primes the packed float drafts' prompt state); and the
   delta scan op priming a full-width Θ=0 layer over the prompt, bitwise
   the state the model's own prefill builds.
5. Format API: the same W_x and W_h through ``SparsityPlan.matvec``, the
   ``row_balanced`` and ``row_balanced_q8`` formats' matvec and
   dual_matvec and ``ops.delta_rb_spmv`` on the card against the plain
   backend, with the launch counts set to 0 just before and read just
   after; and the baseline formats (bank-balanced, block, unstructured)
   at ratio 0.75: mask and byte accounting on the card equal to the CPU's,
   matvec and a mixed-format dual_matvec within tolerance.
6. Attention kernels (run right after phase 2): ``decode_attention``
   (B14) and ``flash_attention`` (B15, bf16 on the tensor cores, float32
   on the SIMT body) against their plain versions at four shapes each,
   float32 and bf16: the qwen3-0.6b serve shape, an odd one (D=64, MQA, a
   window, ragged lengths with 0, 1 and S), a long one (B14 at S=32768,
   B15 at Sk=4096 with Sq < Sk) and head_dim 192 (nemotron-4-340b's);
   B14 twice at the serve shape, bitwise equal, and one CUDA launch a call
   (torch.profiler); timed at the serve shape beside their plain versions
   and ``scaled_dot_product_attention``, B14 also at the long shape; both
   at recurrentgemma-9b's shape (B15: B=4, causal S=2560, window 2048; B14
   at lengths 2560 and ragged ones below and above 2048) held and timed
   the same way; and both at the rest of the zoo's shapes
   (``check_attention_zoo``: B15 without a causal mask at seamless-m4t's
   encoder and cross-attention, groups of 7 and 16, B14 over a
   fixed-length cross memory), held and timed beside SDPA; B14's ``lse=``
   output (``check_decode_lse``) at qwen3-0.6b's and the zoo's decode
   shapes: ``o`` bitwise the launch without it, ``lse`` within LSE_ATOL of
   the plain version's, a row with no live key 0 / -inf, timed with and
   without it.
7. Transformer serve: full-width ``qwen3-0.6b`` in bf16 (seed-0 weights)
   through ``ServeEngine``, greedy, B=8, prompt 512, gen 64, with the
   launch counts read around one generate (28 B15 launches for the
   prefill, every one on the tensor-core body, 28 B14 launches a decode
   step); teacher-forced logits and
   greedy tokens held against the plain path; the ``--brds`` path
   (``transformer_policy(0.75, 0.5)``); and a packed ``lstm_ptb`` draft
   speculating k=4, its tokens equal to target-only.
8. Scheduler: ``ContinuousBatchingEngine`` at lstm_ptb's full width, 64
   slots, over a closed-loop trace of 256 requests (``scheduler_serve``).
9. Training (``training``): full-width lstm_ptb on ZipfInduction(10000),
   B=16, T=35: one dense step on the card against the CPU's, 20 dense
   and 20 masked AdamW steps (pruned entries exactly 0 throughout, no
   kernel launched), the four deployments of the retrained model through
   ``pipeline.run_point`` (each ``score`` launching T × layers of B3, B5,
   B8 or B9, served nll bitwise the manual one, near the plain
   versions'), ``launch.pipeline --smoke --gate 5``, and ``launch.train``
   on qwen3-0.6b at full width in bf16 cut to TTRAIN_LAYERS layers, with
   a checkpoint every 2 steps and a failure injected at 3 (resumed, no
   kernel launched: its training forward never reaches B15), and the
   whole model's gradients and a profiled step.
10. Recurrent families (``recurrent_serve``): recurrentgemma-9b (6 of 38
   layers) and rwkv6-7b (6 of 32) at full width in bf16 through
   ``ServeEngine``, the scheduler
   and a speculating lstm_ptb draft, and ``launch.serve --scorecard
   --metrics`` (its docstring gives the gates).
11. The rest of the zoo (``zoo_serve``): granite-moe-1b-a400m (6 of 24
   layers), qwen3-moe-235b-a22b (4 of 94), seamless-m4t-medium (frames of
   3072 rows), llava-next-34b (6 of 60 layers, 2880 patches) and
   llama3.2-3b with the int8 KV cache (6 of 28), at full width in bf16
   through
   ``ServeEngine``, granite-moe also under the scheduler and with a
   speculating lstm_ptb draft (its docstring gives the gates).
12. Sharded decode (``dist_serve``): full-width ``lstm_ptb`` through
   ``ServeEngine(mesh=)`` on (data, model) meshes of 2 ranks (1, 2) and
   4 ranks (2, 2), every rank a spawned process on this one card under
   gloo (NCCL refuses two ranks on one card; each all-gather is staged
   through host memory), B=8, prompt 32, gen 64, on the packed float, Θ=0
   and Θ=0.05 delta, calibrated int8 and Θ=0 delta + int8 paths: every
   rank's tokens and logits bitwise the single-device chained path's on
   the card for its data group's rows (or the finding printed and held to
   LOGIT_TOL with tokens equal), its launch counts around one generate
   exactly (prompt + gen) x layers of the path's dual SpMV (B1, B4 or B7)
   and of B2, a decode step's collectives exactly one all-gather of the
   rank's h slice a layer, and its wall a step (gloo host-staged); then
   B1, B4, B7 and B2 alone on each shard's rows at 2 and 4 shards, held
   to the unsharded launch's rows and timed with L2 flushed beside it
   (max / min over the shards printed).
13. Sharded training and split-KV decode (``sharded_phase``): meshes
   (2, 2) then (1, 2) of gloo ranks on this card. Full-width lstm_ptb,
   B=16, T=35, through ``training.jit_train_step`` and
   ``pipeline.train_lstm(mesh=)``: the first step's loss and gradients
   held to this card's one-device step, replicated pieces and losses
   bitwise across ranks, masked steps keeping pruned entries and their
   moments exactly 0, ``compression.tree_compressed_psum`` on card
   tensors bitwise their host copies', the (2, 2) checkpoint restored
   onto (1, 2) bitwise (``elastic_restore``); qwen3-0.6b split-KV in
   bf16, B=8, prompt 512, gen 16: 28 B14 launches a decode step a rank,
   every one with ``lse``, tokens and teacher-forced logits held to the
   single-card path (``sharded_phase``'s docstring gives the gates).
   Rank 0 also measures, for phase 14, a train step's and a split-KV
   decode step's aten FLOPs, collectives (torch.profiler), held bytes and
   the peak each allocates above what was live.
14. The production dry run (``dryrun_phase``): ``repro_torch.launch.
   dryrun`` in processes of its own, each one rank of a fake group. (a)
   Phase 13's two cells on its meshes (lstm_ptb's train step at B=16,
   T=35; one qwen3-0.6b split-KV decode step, B=8, cache 528) held to
   what phase 13 measured on gloo rank 0: aten FLOPs, held param and
   moment (or cache) bytes and the collectives by kind and bytes exactly,
   the trace's argument + temp bytes within DRY14_MEM of the card's
   held + batch bytes + the step's peak above them. (b) qwen3-0.6b's
   production grid, 4 shapes on pod16x16 and pod2x16x16: each cell's
   status, GiB a rank, fits, bound and step_s printed. The two train_4k
   traces (the grid's longest) start before phase 10 and run on the host
   beside phases 10-13; the rest start at phase 14.

15. Split-KV serving of the rest of the attention zoo (``splitkv_zoo``):
   phase 11's models on gloo ranks of this card at (1, 2), granite-moe at
   (2, 2) too (its docstring gives the gates).
16. Sharded serving of the recurrent families and of the zoo under the
   sharded scheduler (``sharded_recurrent``): B14's ``start=`` alone at
   recurrentgemma-9b's rank-0 segment (a start inside the segment, at and
   past the length, at 0), then three meshes of gloo ranks side by side:
   recurrentgemma-9b cut to one period at full width on (1, 2), B=4,
   prompt 2560, gen 8 (the window's edge inside rank 0's full segment);
   rwkv6-7b on (1, 2), B=8, prompt 512, at the depth its one-ulp spread
   picks; qwen3-0.6b (4 of 28 layers) under the sharded scheduler on (2,
   2) at RSCHED (its docstring gives the gates).

Prints a ``{"kernels": [...]}`` line and, last, the device line. Exits
non-zero on any failure, and without a card. Each phase's end and seconds
go to stderr too.
"""
from __future__ import annotations

import contextlib
import faulthandler
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import hw  # noqa: E402  (the card's constants)
# live (q, k) pairs of one head under B15's mask: the bound's work
from repro_torch.kernels.ops import live_pairs  # noqa: E402

HBM_BYTES_PER_S = hw.HBM_BW       # H100 SXM device memory rate
FP32_FLOPS = hw.PEAK_FP32_FLOPS   # float32 outside the tensor cores
BF16_FLOPS = hw.PEAK_BF16_FLOPS   # bf16 on the tensor cores, dense
INT8_OPS = hw.PEAK_INT8_OPS       # int8 peak (no int16/int32 entry)
Z_TOL = 1e-4      # z and m sums of up to 8299 products: warp-tree vs
                  # sequential order
CELL_TOL = 1e-5   # c, h: the cell's inputs differ by at most z's rounding
LOGIT_TOL = 1e-3  # 96 recurrent steps of z-level differences through the head
MARGIN = 1e-4     # greedy tokens may differ only below this top-2 margin
SERVE = dict(batch=8, prompt=32, gen=64)
RUNS = 3          # timed generate runs per path; median and range reported
SPEC_K = 4        # draft tokens proposed per speculative round
SCHEMES = ("int8", "q1.11")
KERNELS = ("rb_dual_spmv", "lstm_gates", "fused_brds_lstm_step",
           "delta_rb_dual_spmv", "fused_brds_delta_lstm_step",
           "rb_dual_parts_q8", "fused_brds_lstm_step_q8",
           "fused_brds_delta_lstm_step_q8", "rb_spmv", "rb_spmv_q8",
           "delta_rb_spmv", "fused_brds_lstm_scan",
           "fused_brds_delta_lstm_scan")
# the format-API phase's kernels; the rest launch on the serve paths
FORMAT_KERNELS = ("rb_spmv", "rb_spmv_q8", "delta_rb_spmv")
ATTN_KERNELS = ("decode_attention", "flash_attention")
BF16_ULP = 2.0 ** -7   # bf16 outputs: within one ulp (2^-7 relative) of the
                       # plain version, both rounding float32 values that
                       # differ in the summation order only
ATTN_TOL = 1e-5        # float32 outputs: sums of up to 32768 terms in
                       # another order
LSE_ATOL = 1e-5        # B14's log-sum-exp against the plain version's: one
                       # logf of float32 sums taken in another order
ATTN_FLOPS = 4         # the attention function's flops per live (q, k)
                       # pair and head dim: Q·K^T and P·V, 2 each
# the dense-transformer serve path: qwen3-0.6b at full width, bf16
TSERVE = dict(arch="qwen3-0.6b", batch=8, prompt=512, gen=64, max_len=1024)
# qwen3-0.6b's bf16 logits, kernels vs plain: attention outputs differ by
# up to one bf16 ulp and 28 layers carry that through the residual stream;
# 4 ulps of a logit in [4, 8) (measured 0.047 at max |logit| 4.9)
TF_LOGIT_TOL = 0.125
TF_MARGIN = 0.25       # greedy rows compared up to a top-2 margin below it
# phase 10, the recurrent families at full width in bf16: recurrentgemma-9b
# (38 layers, 12 of them local attention: window 2048, 16 q heads on one
# kv head of 256) with a prompt past the window; rwkv6-7b (32 RWKV6
# layers, no attention)
# layers: the depth kept (PR 29 cut both, widths whole, to give phase 13
# room in the time limit: 2 of recurrentgemma's 12 periods, 6 of rwkv6's
# 32 layers)
RSERVE = {"recurrentgemma-9b": dict(batch=4, prompt=2560, gen=64, heads=16,
                                    kv_heads=1, window=2048, layers=6),
          "rwkv6-7b": dict(batch=8, prompt=512, gen=64, layers=6)}
RRUNS = 2         # timed generate and prefill runs per recurrent model
# recurrentgemma-9b under the scheduler: 8 slots, 16 requests, prompts
# 8-64 tokens, budgets 16-32, four compared with lockstep B=1
RSCHED = dict(slots=8, requests=16, prompt=(8, 64), budget=(16, 32),
              max_len=96, compared=4)
# phase 11, the rest of the zoo at full width in bf16: B, prompt, gen and,
# where cut, the layers kept (zoo_serve's docstring says why)
ZSERVE = {"granite-moe-1b-a400m": dict(batch=8, prompt=512, gen=64,
                                       scheduler=True, draft=True, layers=6),
          # qk-normed: gated on its own weights (fan_in=False)
          "qwen3-moe-235b-a22b": dict(batch=4, prompt=512, gen=32,
                                      layers=4, fan_in=False),
          "seamless-m4t-medium": dict(batch=4, prompt=64, gen=64,
                                      frames=3072),
          # 2880 patch embeddings, then 64 text tokens
          "llava-next-34b": dict(batch=2, prompt=2944, gen=32, layers=6),
          "llama3.2-3b": dict(batch=8, prompt=512, gen=64, kv_quant=True,
                              layers=6)}
ZBUSY_GEN = 8          # decode steps of the generate whose busy share is read
ZRUNS = 2              # timed runs a phase 11 figure, the median reported
INT8_GATE = 0.08       # the reference's int8-cache gate (tests/test_archs.py)
# phase 6 at the zoo's shapes: B15 (causal or not) and B14 (at a length)
ZATTN = {
    "flash": [
        ("seamless-m4t encoder", dict(B=4, Hq=16, Hkv=16, Sq=3072, Sk=3072,
                                      D=64, causal=False)),
        ("seamless-m4t cross", dict(B=4, Hq=16, Hkv=16, Sq=64, Sk=3072,
                                    D=64, causal=False)),
        ("granite-moe", dict(B=8, Hq=16, Hkv=8, Sq=512, Sk=512, D=64,
                             causal=True)),
        ("qwen3-moe", dict(B=4, Hq=64, Hkv=4, Sq=512, Sk=512, D=128,
                           causal=True)),
        ("llava G=7", dict(B=2, Hq=56, Hkv=8, Sq=2944, Sk=2944, D=128,
                           causal=True))],
    "decode": [
        ("seamless-m4t self", dict(B=4, Hq=16, Hkv=16, S=128, D=64,
                                   length=96)),
        ("seamless-m4t cross", dict(B=4, Hq=16, Hkv=16, S=3072, D=64,
                                    length=3072)),
        ("granite-moe", dict(B=8, Hq=16, Hkv=8, S=576, D=64, length=544)),
        ("qwen3-moe", dict(B=4, Hq=64, Hkv=4, S=544, D=128, length=528)),
        ("llava G=7", dict(B=2, Hq=56, Hkv=8, S=2976, D=128, length=2960))]}
ZOO_TIMES = []         # B14 / B15 at the zoo's shapes (phase 6)
GRAPH_ROWS = []        # captured vs host loop, one row a serve path
D256_TIMES = {}        # B14 / B15 at recurrentgemma-9b's shape (phase 6)
# the port's CUDA kernels by symbol, grouped with the wrappers that count
# their launches (a template's float and delta forms share a symbol; B15
# has a tensor-core body and a SIMT one)
KERNEL_SYMBOLS = (
    (("fused_staged_kernel",), ("fused_brds_lstm_step",
                                "fused_brds_delta_lstm_step")),
    (("fused_step_q8_kernel",), ("fused_brds_lstm_step_q8",
                                 "fused_brds_delta_lstm_step_q8")),
    (("fused_scan_kernel",), ("fused_brds_lstm_scan",
                              "fused_brds_delta_lstm_scan")),
    (("rb_dual_staged_kernel",), ("rb_dual_spmv",)),
    (("delta_dual_staged_kernel",), ("delta_rb_dual_spmv",)),
    (("rb_dual_parts_staged_kernel",), ("rb_dual_parts_q8",)),
    (("lstm_gates_kernel",), ("lstm_gates",)),
    (("rb_spmv_staged_kernel",), ("rb_spmv",)),
    (("delta_spmv_staged_kernel",), ("delta_rb_spmv",)),
    (("rb_spmv_q8_staged_kernel",), ("rb_spmv_q8",)),
    (("decode_cluster_kernel",), ("decode_attention",)),
    (("flash_attention_kernel", "flash_tc_kernel"), ("flash_attention",)),
)
# the scheduler at full width: the reference's steady-state slot count, a
# closed-loop trace of 256 requests, prompts 8-64 and budgets 16-64 tokens
SCHED = dict(slots=64, requests=256, prompt_short=(8, 32),
             prompt_long=(33, 64), output_lens=(16, 64), max_len=128,
             load_seed=0, compared=32)

# phase 9, training: lstm_ptb at full width on ZipfInduction(V=10000),
# B=16, T=35 (the PTB-large BPTT length), 20 AdamW steps dense then 20
# masked at lstm_policy(0.75, 0.5)
TRAIN = dict(batch=16, seq=35, steps=20, lr=1e-3, retrain_lr=5e-4)
# one dense step on the card vs the CPU from the same weights and batch:
# float32 sums in another order through 35 recurrent steps and the head
STEP_LOSS_RTOL = 1e-5
# each leaf's max |Δg| over its max |g| (H100 80GB HBM3, 700 W: 9.49e-7)
STEP_GRAD_RTOL = 1e-5
# params after it: AdamW's update is lr·m̂/(√v̂ + 1e-8), and where |g| is
# near eps a last-bit difference moves it by a part of lr (on an H100 80GB
# HBM3: 2.02e-5 = 0.02 lr, on 1.2e-5 of the entries beyond 1e-6)
STEP_PARAM_ATOL = TRAIN["lr"] / 10
STEP_PARAM_SHARE = 1e-3     # of entries allowed beyond 1e-6
# the four deployments' nll, kernels vs plain versions: the head over
# logits within LOGIT_TOL (Θ=0.05 may flip a threshold decision)
NLL_RTOL = 1e-4
# qwen3-0.6b through launch.train at full width, bf16, cut to TTRAIN_LAYERS
# of its 28 layers (PR 29: its checkpoints, 7.5 GB each at full depth, took
# ~75 s of the time limit): checkpoints at steps 2 and 4, a failure at 3
TTRAIN = ["--arch", "qwen3-0.6b", "--brds", "--batch", "4", "--seq", "256",
          "--steps", "4", "--save-every", "2", "--inject-failure-at", "3"]
TTRAIN_LAYERS = 4
ATTN_LEAVES = ("wq", "wk", "wv", "wo", "q_norm", "k_norm")
# phase 12, sharded decode: (data, model) meshes of 2 then 4 ranks on the
# one card under gloo (NCCL refuses two ranks on one card); the shard
# kernels timed at the model-axis counts 2 (the 4-rank mesh's rows, B/2)
# and 4 (375 units a shard, an odd count)
DMESHES = ((1, 2), (2, 2))
DSHARDS = (2, 4)
DRUNS = 2         # timed generates a rank and path, the median reported
# phase 13: sharded training (lstm_ptb, TRAIN's B and T) and split-KV
# decode (qwen3-0.6b in bf16) on meshes (2, 2) then (1, 2) of this card
SHARD13 = dict(steps=3, masked=3, ckpt_step=7)
# a rank's params and optimizer state held plus what its step allocates
# above them, over one card's: the model axis splits the weights and their
# work (lstm_ptb's: ~0.5 at (1, 2), ~0.45 at (2, 2), estimated)
SHARD13_MEM = 0.65
# gen 16 (it was 64): the split-KV generate was phase 13's largest part
# (51.0 s at (2, 2) under gloo); widths, prompt, the teacher-forced steps
# and every gate kept
SPLIT = dict(arch="qwen3-0.6b", batch=8, prompt=512, gen=16, tf=8,
             tf_steps=(0, 3, 7))


# phase 14, the production dry run: its records under build/dryrun14;
# the trace's argument + temp bytes against the card's held + batch bytes
# + the step's peak above them (cuBLAS's workspace and the allocator's
# rounding are in the card's figure)
DRY14_OUT = ROOT / "build" / "dryrun14"
DRY14_MEM = 0.15
DRY14_GATES = {
    "train": ("lstm_ptb", "train_4k", "train_b16_s35",
              ["--batch", "16", "--seq", "35"]),
    "split": ("qwen3-0.6b", "decode_32k", "decode_b8_s528",
              ["--batch", "8", "--seq", "528"])}   # P + G of SPLIT
DRY14_GRID = "qwen3-0.6b"
CHILDREN: list = []     # the dry-run processes, ended at exit
# phase 15: split-KV serving of the rest of the attention zoo on gloo ranks
# of this card, bf16 at full width (depth cut where named): each arch on
# (1, 2), granite-moe on (2, 2) too; gen ZGEN, teacher-forced logits kept
# at ZTF_STEPS
ZSPLIT = {"granite-moe-1b-a400m": dict(batch=8, prompt=512, hold_moe=True),
          "seamless-m4t-medium": dict(batch=4, prompt=64, frames=3072),
          # 2880 patch embeddings, then 64 text tokens
          "llava-next-34b": dict(batch=2, prompt=2944, layers=6),
          "llama3.2-3b": dict(batch=8, prompt=512, layers=6, kv_quant=True),
          # qk-normed: gated on its own weights (fan_in=False)
          "qwen3-moe-235b-a22b": dict(batch=4, prompt=512, layers=2,
                                      fan_in=False)}
ZSPLIT_MESHES = {(1, 2): tuple(ZSPLIT), (2, 2): ("granite-moe-1b-a400m",)}
ZGEN = 8
ZTF_STEPS = (0, 3, 7)
# a rank's card memory right after the sharded init over the one-card
# params at (1, 2): the model axis halves every split leaf (~0.5)
ZSPLIT_MEM = 0.6
# phase 16: sharded serving of the recurrent families and of the zoo under
# the sharded scheduler, gloo ranks on this card, bf16 at full width, seed-0
# weights, the three meshes side by side: (a) recurrentgemma-9b cut to one
# period (rec, rec, attn_local), phase 10's B=4, prompt 2560 and window
# 2048, gen RGEN, on (1, 2): a cache of 2568 positions, so rank 0's full
# segment of 1284 holds every step's window edge (keys 513-520); (b)
# rwkv6-7b at phase 10's B=8 and prompt 512 on (1, 2), at the deepest of
# RWKV_DEPTHS whose one-ulp spread stays under a quarter of TF_LOGIT_TOL;
# (c) qwen3-0.6b cut to SCHED16["layers"] of 28 under the sharded
# scheduler at RSCHED on (2, 2)
# (recurrentgemma with wq / wk at the fan-in scale, as phase 15 holds the
# attention zoo: at the reference's init its scores reach the hundreds and
# ulps of q / k that the ranks' reductions move flip its one-hot softmax)
RSPLIT = {"recurrentgemma-9b": dict(batch=4, prompt=2560, layers=3,
                                    mesh=(1, 2), fan_in=True),
          "rwkv6-7b": dict(batch=8, prompt=512, mesh=(1, 2))}
RGEN = 8
RWKV_DEPTHS = (1, 2, 3, 4)
SCHED16 = dict(arch="qwen3-0.6b", layers=4, mesh=(2, 2))
# phase 17: tensor-parallel training of the zoo, one jit_train_step each on
# (1, 2) gloo ranks of this card, bf16 at full width (depth cut where
# named: recurrentgemma-9b to one period, rwkv6-7b to the one layer its
# one-ulp spread takes, seamless-m4t-medium and llava-next-34b to 2,
# qwen3-0.6b to 4 for the
# vocab-parallel loss), the "tp" layout (the experts, the heads and the
# vocabulary over model; the "dp" configs too), seed-0 weights with wq / wk
# at the fan-in scale where phases 15-16 take them (qk-normed qwen3 on its
# own). B and S cut so that the one-device step each rank runs first, then
# the two ranks (each half the params, the gradients and the float32
# moment, and its pieces of the one-device gradients) fit the card
TP17 = {"granite-moe-1b-a400m": dict(batch=4, seq=512, fan_in=True),
        "recurrentgemma-9b": dict(batch=2, seq=512, layers=3, fan_in=True),
        "rwkv6-7b": dict(batch=2, seq=512, layers=1),
        # 2 encoder and 2 decoder layers: the 12-layer random encoder's
        # memory collapses toward one row, and the cross-attention's q / k
        # gradients are then cancellation: their one-ulp spread 0.27 of
        # their norm at full depth, 0.06 at 2 (bf16 on the CPU)
        "seamless-m4t-medium": dict(batch=2, seq=256, frames=256,
                                    layers=2, enc_layers=2, fan_in=True),
        # 2880 patch embeddings, then 192 text tokens (the training
        # forward's blocked attention takes multiples of its 1024-key block)
        "llava-next-34b": dict(batch=1, seq=3072, layers=2, fan_in=True),
        "qwen3-0.6b": dict(batch=4, seq=512, layers=4)}
TP17_MESH = (1, 2)
# the sharded loss and each gradient leaf (of its largest entry) against
# this card's one-device step: within this many times the loss's and that
# leaf's own one-ulp spread (the most two steps move it with half of every
# param's entries one ulp up: the ranks' partial sums round at every
# layer, as such a nudge moves each)
TP17_SPREAD = 2.0
TP17_NUDGES = (3, 4)        # the nudges' generator seeds
# a leaf whose spread in norm reaches this (of its norm) is too chaotic for
# its gate to mean anything, and its model fails: twice it stays below
# 0.44, the smallest gap of a leaf's max that the serving forms' backward
# left before it summed the ranks' shares (measured with the fault tests
# of tests/test_torch_tp_train_zoo.py)
TP17_MAX_SPREAD = 0.2
TP17_MEM = ZSPLIT_MEM       # a rank's params and moments over one card's
# SGD with momentum: one float32 moment. AdamW's functional update holds
# the old and new moments at once (2 + 2 a param): recurrentgemma-9b's rank
# would peak near 44 GB, two of them past the card
TP17_OPT_KW = dict(name="sgdm", lr=1e-4, warmup_steps=1, total_steps=10)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def versions_line() -> str:
    """The CUDA driver's and the toolkit's versions: a programmatic
    launch is recorded in a captured graph as a programmatic edge from
    CUDA 12.3."""
    from repro_torch.kernels import _build
    drv = subprocess.run(
        ["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.split()[0]
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    return f"driver {drv}; nvcc {nvcc[-1]}"


def bound(nbytes: int, flops: int, int_ops: int = 0,
          bf16_flops: int = 0) -> tuple[float, str]:
    """Least time (ms) for the work: bytes over the memory rate vs the
    operations over the peak rate of their type (float32; integer at the
    int8 rate; bf16 operands at the tensor cores' rate), the larger of
    the two."""
    tb = nbytes / HBM_BYTES_PER_S
    tf = (flops / FP32_FLOPS + int_ops / INT8_OPS
          + bf16_flops / BF16_FLOPS)
    return max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations"


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def packed_bytes(s) -> int:
    """Values (or codes) and deltas of the logical rows, plus a q8
    packing's per-row combined scales: what a kernel must read
    (``pad_packed``'s zero rows are not)."""
    n = s.rows * s.K * (s.values.element_size() + s.deltas.element_size())
    return n + (4 * s.rows if hasattr(s, "scales") else 0)


_TYPES = {"a": "int8", "s": "int16", "i": "int32"}


def ptxas_serve_tier(out: str) -> list[str]:
    """From ``nvcc -Xptxas -v`` output: registers and spill bytes of each
    kernel instantiation the B=8 serve path launches (the 8-accumulator
    tier, int16 column deltas), e.g. ``fused_step_q8_kernel<int8,int16,
    int16,8>: 48 registers, 0 B spill``."""
    import re
    rows, name, spill = [], None, 0
    for ln in out.splitlines():
        m = re.search(r"Compiling entry function '(\w+?)_kernelI([asi]+)"
                      r"Li(\d+)E", ln)
        if m:
            # the mangled kernel name ends its length-prefixed identifier
            head = m.group(1) + "_kernel"
            base = next((head[-n:] for n in range(1, len(head))
                         if head[:-n].endswith(str(n))), head)
            name, spill = (base, m.group(2), int(m.group(3))), 0
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            base, types, nb = name
            deltas = types[1:] if "q8" in base else types
            if nb == 8 and set(deltas) == {"s"}:
                rows.append(f"{base}<{','.join(_TYPES[c] for c in types)},"
                            f"{nb}>: {m.group(1)} registers, {spill} B "
                            "spill")
            name = None
    return rows


def ptxas_attention(out: str, flash_smem: int) -> list[str]:
    """Registers and spill bytes of the attention instantiations the
    qwen3-0.6b serve path launches (bf16, head_dim 128; decode with two q
    heads a block; flash on the tensor cores with two consumer
    warpgroups), and the flash block's dynamic shared memory."""
    import re
    want = {"decode_cluster_kernelI13__nv_bfloat16Li128ELi2EE":
            "decode_cluster<bf16,128,2 heads>",
            "flash_tc_kernelILi128ELi2E": "flash_tc<bf16,128,2 heads>"}
    rows, name, spill = [], None, 0
    for ln in out.splitlines():
        if "Compiling entry function" in ln:
            name = next((v for k, v in want.items() if k in ln), None)
            spill = 0
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            smem = (f", {flash_smem} B dynamic shared memory"
                    if name.startswith("flash") else "")
            rows.append(f"{name}: {m.group(1)} registers, {spill} B spill"
                        + smem)
            name = None
    return rows


# the redesigned instantiations at the serve tier (B=8, lstm_ptb; B14 at
# qwen3-0.6b's bf16 head_dim 128, two q heads a block): mangled name
# fragment -> what chip_smoke prints
REDESIGNED = {"fused_scan_kernelILi8ELb1ELb1ELb0EE":
              "fused_scan_kernel<8, xs staged, h staged> (B12)",
              "fused_scan_kernelILi8ELb1ELb1ELb1EE":
              "fused_scan_kernel<8, dxm staged, dh staged, delta> (B13)",
              "fused_step_q8_kernelIaLi8ELb0ELb1ELb0EE":
              "fused_step_q8_kernel<int8, 8, staged> (B8 int8)",
              "fused_step_q8_kernelIsLi8ELb0ELb1ELb0EE":
              "fused_step_q8_kernel<int16, 8, staged> (B8 q1.11)",
              "fused_step_q8_kernelIaLi8ELb0ELb1ELb1EE":
              "fused_step_q8_kernel<int8, 8, staged, delta> (B9 int8)",
              "fused_step_q8_kernelIsLi8ELb0ELb1ELb1EE":
              "fused_step_q8_kernel<int16, 8, staged, delta> (B9 q1.11)",
              "fused_staged_kernelILi8ELb0ELb0EE":
              "fused_staged_kernel<8> (B3)",
              "rb_dual_staged_kernelILi8ELb0EE":
              "rb_dual_staged_kernel<8> (B1)",
              "fused_staged_kernelILi8ELb0ELb1EE":
              "fused_staged_kernel<8, delta> (B5)",
              "delta_dual_staged_kernelILi8ELb0EE":
              "delta_dual_staged_kernel<8> (B4)",
              "rb_dual_parts_staged_kernelIaLi8ELb0ELb1EE":
              "rb_dual_parts_staged_kernel<int8, 8, staged> (B7 int8)",
              "rb_dual_parts_staged_kernelIsLi8ELb0ELb1EE":
              "rb_dual_parts_staged_kernel<int16, 8, staged> (B7 q1.11)",
              "rb_spmv_q8_staged_kernelIaLi8ELb0ELb1EE":
              "rb_spmv_q8_staged_kernel<int8, 8, staged> (B10 int8)",
              "rb_spmv_q8_staged_kernelIsLi8ELb0ELb1EE":
              "rb_spmv_q8_staged_kernel<int16, 8, staged> (B10 q1.11)",
              "lstm_gates_kernel": "lstm_gates_kernel (B2)",
              "rb_spmv_staged_kernelILi8ELb0EE":
              "rb_spmv_staged_kernel<8> (B11)",
              "delta_spmv_staged_kernelILi8ELb0EE":
              "delta_spmv_staged_kernel<8> (B6)",
              "decode_cluster_kernelI13__nv_bfloat16Li128ELi2EE":
              "decode_cluster_kernel<bf16, 128, 2 heads> (B14)"}


def ptxas_redesigned(out: str) -> dict:
    """From ``nvcc -Xptxas -v`` output: (registers, spill store bytes) of
    each REDESIGNED instantiation found in it."""
    import re
    got, name, spill = {}, None, 0
    for ln in out.splitlines():
        if "Compiling entry function" in ln:
            name = next((k for k in REDESIGNED if k in ln), None)
            spill = 0
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            got[name] = (int(m.group(1)), spill)
            name = None
    return got


def occupancy(torch, device) -> None:
    """Prints, for the redesigned B12, B13, B8, B9, B7 and B10 (int8,
    q1.11), B3, B1, B5, B4, B11, B6 and B2 instantiations at the serve
    tier (B=8, int16 deltas) and B14's at
    qwen3-0.6b's decode shape: ptxas's registers and spill bytes, the
    launch plan's dynamic shared memory and grid, and the blocks an SM and
    waves the runtime's occupancy calculator gives at that grid (beside the
    plain ``plan.blocks_per_sm``); for B14 also its cluster size; and
    whether a B2 block fits on an SM beside a B1 block (B2 is launched as
    B1's programmatic dependent). Fails unless each has no spill and no
    local array, and unless all but B14 run in one wave."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as kdec
    from repro_torch.kernels import fused_scan as kscan
    from repro_torch.kernels.lstm_gates import gates_info
    from repro_torch.kernels import plan as P
    from repro_torch.kernels import rb_spmv as krb
    from repro_torch.kernels import rb_spmv_q8 as kq8
    ptx = {}
    for src in ("fused_scan", "fused_step", "rb_spmv", "delta_rb_spmv",
                "rb_spmv_q8", "lstm_gates", "attention"):
        ptx.update(ptxas_redesigned(_build.BUILD_LOG.get(src, "")))
    sms = _build.sm_count(device)
    B, X, H, Kx, Kh = SERVE["batch"], 1500, 1500, 375, 750
    rows = []
    for key, delta in (("fused_scan_kernelILi8ELb1ELb1ELb0EE", False),
                       ("fused_scan_kernelILi8ELb1ELb1ELb1EE", True)):
        sp = P.scan_plan(X=X, H=H, T=SERVE["prompt"], B=B, Kx=Kx, Kh=Kh,
                         delta=delta, sms=sms)
        rows.append((key, sp, P.SCAN_THREADS, kscan.scan_info(sp, B, device)))
    for key, cb, delta in (("fused_step_q8_kernelIaLi8ELb0ELb1ELb0EE", 1, 0),
                           ("fused_step_q8_kernelIsLi8ELb0ELb1ELb0EE", 2, 0),
                           ("fused_step_q8_kernelIaLi8ELb0ELb1ELb1EE", 1, 1),
                           ("fused_step_q8_kernelIsLi8ELb0ELb1ELb1EE", 2, 1)):
        qp = P.q8_plan(X=X, H=H, B=B, Kx=Kx, Kh=Kh, code_bytes=cb,
                       delta=bool(delta), sms=sms)
        rows.append((key, qp, P.Q8_THREADS,
                     kq8.q8_info(qp, B, cb, device, delta=bool(delta))))
    for key, cb in (("rb_dual_parts_staged_kernelIaLi8ELb0ELb1EE", 1),
                    ("rb_dual_parts_staged_kernelIsLi8ELb0ELb1EE", 2)):
        qp = P.q8_plan(X=X, H=H, B=B, Kx=Kx, Kh=Kh, code_bytes=cb, R=4 * H,
                       sms=sms)
        rows.append((key, qp, P.Q8_THREADS,
                     kq8.q8_info(qp, B, cb, device, fused=False)))
    for key, cb in (("rb_spmv_q8_staged_kernelIaLi8ELb0ELb1EE", 1),
                    ("rb_spmv_q8_staged_kernelIsLi8ELb0ELb1EE", 2)):
        qp = P.q8_plan(X=X, B=B, Kx=Kh, code_bytes=cb, R=4 * H, sms=sms)
        rows.append((key, qp, P.Q8_THREADS,
                     kq8.q8_info(qp, B, cb, device, fused=False)))
    gp = P.gates_plan(B=B, H=H, sms=sms)
    rows.append(("lstm_gates_kernel", gp, P.GATES_THREADS,
                 gates_info(gp, device)))
    for key, fused, delta in (
            ("fused_staged_kernelILi8ELb0ELb0EE", True, False),
            ("rb_dual_staged_kernelILi8ELb0EE", False, False),
            ("fused_staged_kernelILi8ELb0ELb1EE", True, True),
            ("delta_dual_staged_kernelILi8ELb0EE", False, True)):
        lp = P.stream_plan(X=X, H=H, R=4 * H, B=B, Kx=Kx, Kh=Kh, fused=fused,
                           sms=sms)
        rows.append((key, lp, P.STREAM_THREADS,
                     krb.stream_info(lp, B, device, fused=fused,
                                     delta=delta)))
    lp = P.stream_plan(X=X, R=4 * H, B=B, Kx=Kx, sms=sms)
    for key, delta in (("rb_spmv_staged_kernelILi8ELb0EE", False),
                       ("delta_spmv_staged_kernelILi8ELb0EE", True)):
        rows.append((key, lp, P.STREAM_THREADS,
                     krb.stream_info(lp, B, device, delta=delta)))
    # B14 at the qwen3-0.6b decode shape: B=8, 16 q / 8 kv heads of 128,
    # bf16, a 1024-row cache
    dp = P.decode_plan(B=TSERVE["batch"], Hkv=8, G=2, S=TSERVE["max_len"],
                       D=128, elem_bytes=2, sms=sms)
    dkey = "decode_cluster_kernelI13__nv_bfloat16Li128ELi2EE"
    rows.append((dkey, dp, P.DEC_THREADS,
                 kdec.decode_info(dp, 128, 2, torch.bfloat16, device)))
    for key, plan, threads, info in rows:
        regs, spill = ptx.get(key, (None, None))
        calc = P.blocks_per_sm(info["registers"], threads, plan.smem)
        extra = (f"; clusters of {plan.splits} blocks, {plan.stages} ring "
                 f"stages of {plan.stage_bytes} B, {info['heads']} q heads "
                 "a block" if key == dkey else "")
        log(f"[occupancy] {REDESIGNED[key]}: ptxas {regs} registers, {spill} "
            f"B spill; runtime {info['registers']} registers, "
            f"{info['local_bytes']} B local; {plan.smem} B dynamic shared "
            f"memory; {info['blocks_per_sm']} block(s) an SM (plan."
            f"blocks_per_sm: {calc}), grid {plan.grid} blocks on {sms} "
            f"SMs: {info['waves']} wave(s){extra}")
        if spill != 0 or info["local_bytes"] != 0 or (
                key != dkey and info["waves"] != 1):
            raise AssertionError(f"{REDESIGNED[key]}: spills, keeps an "
                                 "array in local memory or takes more "
                                 "than one wave")
    # B2 beside B1: registers, warps and shared memory of one block each
    info = {key: (plan, threads, got) for key, plan, threads, got in rows}
    b1, b2 = (info[k] for k in ("rb_dual_staged_kernelILi8ELb0EE",
                                "lstm_gates_kernel"))
    fits = P.fits_beside(
        *((got["registers"], threads, plan.smem + got["static_smem"])
          for plan, threads, got in (b1, b2)))
    log(f"[occupancy] lstm_gates (B2, {b2[2]['registers']} registers x "
        f"{b2[1]} threads) beside rb_dual_spmv (B1, {b1[2]['registers']} "
        f"registers x {b1[1]} threads, {b1[0].smem} B shared): a B2 block "
        + ("fits on an SM beside a B1 block" if fits else
           "does not fit beside a B1 block; B2's blocks start as B1's "
           "blocks leave"))


def ptxas_entry(out: str, frag: str):
    """(registers, spill store bytes, stack frame bytes) of the first
    instantiation in ``nvcc -Xptxas -v`` output whose mangled name holds
    ``frag``, or None when none was built."""
    import re
    name, spill, stack = False, 0, 0
    for ln in out.splitlines():
        if "Compiling entry function" in ln:
            name, spill, stack = frag in ln, 0, 0
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      ln)
        if m and name:
            stack, spill = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            return int(m.group(1)), spill, stack
    return None


def occupancy_d256(torch, device) -> None:
    """Phase 1 at recurrentgemma-9b's local attention (bf16, head_dim 256,
    16 q heads on one kv head, window 2048): B15's tensor-core body (one
    consumer warpgroup a block at D=256, ``plan.flash_warpgroups``) and
    B14 (one q head a block, ``plan.decode_heads``): ptxas's registers,
    spills and stack frame, the dynamic shared memory (B15's from the
    library, held to ``plan.flash_smem``; B14's plan at the decode shape,
    B=4 over a 2624-row cache) against the 227 KB a block may take, and
    B14's runtime registers, local bytes and blocks an SM. Fails on a
    spill, a stack frame, shared memory past the limit, or a two-warpgroup
    D=256 body in the build."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as kdec
    from repro_torch.kernels import plan as P
    out = _build.BUILD_LOG.get("attention", "")
    R = RSERVE["recurrentgemma-9b"]
    G = R["heads"] // R["kv_heads"]
    if ptxas_entry(out, "flash_tc_kernelILi256ELi2E") is not None:
        raise AssertionError("the two-warpgroup D=256 flash body was built: "
                             "it spills")
    smem = _build.load("attention").brds_flash_attention_bf16_smem(256, G)
    dp = P.decode_plan(B=R["batch"], Hkv=R["kv_heads"], G=G,
                       S=R["prompt"] + R["gen"], D=256, elem_bytes=2,
                       sms=_build.sm_count(device))
    info = kdec.decode_info(dp, 256, G, torch.bfloat16, device)
    rows = (("flash_tc_kernelILi256ELi1E",
             f"flash_tc<bf16, 256, {P.flash_warpgroups(G, 256)} warpgroup> "
             "(B15)", smem, ""),
            ("decode_cluster_kernelI13__nv_bfloat16Li256ELi1EE",
             f"decode_cluster<bf16, 256, {dp.heads} head> (B14)", dp.smem,
             f"; runtime {info['registers']} registers, "
             f"{info['local_bytes']} B local, {info['blocks_per_sm']} "
             f"block(s) an SM, grid {dp.grid} ({dp.groups} head groups x "
             f"{dp.splits} slices x {R['batch']} rows): {info['waves']} "
             "wave(s)"))
    for frag, name, sm, extra in rows:
        got = ptxas_entry(out, frag)
        if got is None:
            raise AssertionError(f"{name}: not in the build log")
        regs, spill, stack = got
        log(f"[occupancy] {name} at recurrentgemma-9b's shape: ptxas {regs} "
            f"registers, {spill} B spill, {stack} B stack frame; {sm} B "
            f"dynamic shared memory (limit {P.SMEM_PER_BLOCK}){extra}")
        if spill or stack or sm > P.SMEM_PER_BLOCK:
            raise AssertionError(f"{name}: spills, keeps a stack frame or "
                                 "takes more shared memory than a block may")
    if smem != P.flash_smem(G, 256) or info["local_bytes"] or \
            info["heads"] != 1:
        raise AssertionError(f"B15's shared memory {smem} != plan's "
                             f"{P.flash_smem(G, 256)}, or B14 {info}")


def cell(z, c, pwl=False):
    """The plain cell on z (B, 4H) grouped [f; i; g; o]."""
    from repro_torch.kernels.ref import lstm_cell_ref
    H = z.shape[-1] // 4
    return lstm_cell_ref(*(z[:, i * H:(i + 1) * H] for i in range(4)), c,
                         pwl=pwl)


def make_case(torch, device, *, B, X, H, spar_x, spar_h, seed):
    """Packed weights (float, int8 and q1.11, rows padded as serving pads
    them) and activations from one seeded generator on the card."""
    from repro_torch.core import pack_from_dense, pad_packed
    from repro_torch.quant import quantize_packed
    g = torch.Generator(device=device).manual_seed(seed)
    rand = lambda *shape, s=1.0: torch.randn(*shape, generator=g,
                                             device=device) * s
    wx, wh = rand(4 * H, X, s=X ** -0.5), rand(4 * H, H, s=H ** -0.5)
    sx, sh = pack_from_dense(wx, spar_x), pack_from_dense(wh, spar_h)
    case = dict(B=B, X=X, H=H, sx=pad_packed(sx), sh=pad_packed(sh),
                x=rand(B, X), h=rand(B, H), c=rand(B, H),
                bias=rand(4 * H, s=0.1))
    case["q8"] = {spec: (pad_packed(quantize_packed(sx, spec)),
                         pad_packed(quantize_packed(sh, spec)))
                  for spec in SCHEMES}
    # fired masks: about half the columns, and all of them (Θ = 0)
    case["fired"] = {share: tuple(
        (torch.rand(B, n, generator=g, device=device) < share).float()
        for n in (X, H)) for share in (0.5, 1.0)}
    case.update(dx=rand(B, X, s=0.5), dh=rand(B, H, s=0.3),
                m=rand(B, 4 * H))
    # the scans: T = the serve prompt's steps, and delta references
    case.update(xs=rand(SERVE["prompt"], B, X), x_ref=rand(B, X),
                h_ref=rand(B, H))
    return case


def q8_acts(case, spec):
    """Activation codes and scales for a q8 case: a static max-abs scale
    for int8 (as calibration gives), 2^-11 for q1.11."""
    from repro_torch.quant import parse_scheme, quantize
    scheme = parse_scheme(spec)
    out = []
    for v in (case["x"], case["h"]):
        s = scheme.act_scale(float(v.abs().max()) / scheme.qmax)
        out += [quantize(v, s, scheme), s]
    return out


def check_kernels(torch, device, flush):
    """Phase 2: each kernel against its plain version; returns per-kernel
    records (errors, times, bounds)."""
    from repro_torch.core import unpack
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rb_spmv_q8 as kq8
    from repro_torch.kernels._build import time_ms
    rec = {n: dict(max_abs_err=0.0) for n in KERNELS}

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
    # a hidden state too wide for the float scan to stage at B > 8: its
    # recurrence gathers h from global memory
    tall = make_case(torch, device, B=12, X=64, H=4000, spar_x=0.75,
                     spar_h=0.5, seed=4)
    for tag, cs in (("full", full), ("small", small), ("wide", wide),
                    ("tall", tall)):
        sx, sh, H = cs["sx"], cs["sh"], cs["H"]
        log(f"[kernels] {tag}: B={cs['B']} X={cs['X']} H={H} R={sx.rows} "
            f"padded to {sx.values.shape[0]}, Kx={sx.K} Kh={sh.K}, deltas "
            f"{sx.deltas.dtype}/{sh.deltas.dtype}")
        check_float(torch, ops, err, tag, cs)
        check_delta(torch, ops, err, tag, cs)
        check_q8(torch, ops, ref, kq8, err, tag, cs)
        check_single(torch, ops, err, tag, cs)
        check_delta_q8(torch, ops, err, tag, cs)
        check_scans(torch, ops, err, tag, cs)
    check_batch_tiles(torch, ops, err)
    # past 65535 columns the staged float kernels scan one chunk of column
    # deltas a word (below, two): int32 deltas, x gathered (B11 too), and
    # B7 gathers its codes
    very_wide = make_case(torch, device, B=3, X=70000, H=64, spar_x=0.75,
                          spar_h=0.5, seed=9)
    check_float(torch, ops, err, "very wide", very_wide)
    check_delta(torch, ops, err, "very wide", very_wide)
    check_q8(torch, ops, ref, kq8, err, "very wide", very_wide)
    check_single(torch, ops, err, "very wide", very_wide)
    # the fused q8 and delta-q8 steps (B8, B9) and the float and float
    # delta pairs (B1, B3, B4, B5) at the other batch tiers, full width:
    # B=1 and 16 in one tile, 64 in four (rows of 375 and 750 entries,
    # neither a multiple of the 4 entries a lane loads nor of the 32 a warp
    # takes)
    for B in (1, 16, 64):
        cs = make_case(torch, device, B=B, X=1500, H=1500, spar_x=0.75,
                       spar_h=0.5, seed=6 + B)
        check_float(torch, ops, err, f"full B={B}", cs)
        check_q8(torch, ops, ref, kq8, err, f"full B={B}", cs)
        check_delta_q8(torch, ops, err, f"full B={B}", cs)
        check_delta(torch, ops, err, f"full B={B}", cs)
        if B == 16:
            # the scans' largest one-tile batch
            check_tile_scans(torch, ops, err, cs)

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

    def fused_cell():
        # PyTorch's fused LSTM cell takes the gates as (i, f, g, o) and a
        # second gate matrix, zero here; the permuted z is set-up
        torch.ops.aten._thnn_fused_lstm_cell(z_ifgo, z_zero, c)

    z_ifgo = torch.cat([zs[1], zs[0], zs[2], zs[3]], 1)
    z_zero = torch.zeros_like(z_ifgo)
    hy, cy, _ = torch.ops.aten._thnn_fused_lstm_cell(z_ifgo, z_zero, c)
    cg, hg = ops.lstm_gates(*zs, c, backend="cuda")
    log(f"  _thnn_fused_lstm_cell (lstm_gates' library call) vs lstm_gates: "
        f"max|c, h diff| {max((cy - cg).abs().max().item(), (hy - hg).abs().max().item()):.3e}")
    runs = {
        "rb_dual_spmv": (
            lambda: ops.rb_dual_spmv(sx, x, sh, h, b, backend="cuda"),
            lambda: ops.rb_dual_spmv(sx, x, sh, h, b, backend="ref"),
            addmm_pair,
            bound(weights + nbytes(x, h, b, z), flops)),
        "lstm_gates": (
            lambda: ops.lstm_gates(*zs, c, backend="cuda"),
            lambda: ops.lstm_gates(*zs, c, backend="ref"),
            fused_cell,
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
    runs.update(delta_runs(torch, ops, full, wxT, whT))
    runs.update(q8_runs(torch, full))
    runs.update(single_runs(torch, ops, full, "W_x"))
    scans, steps = scan_runs(torch, ops, full, wx, wh)
    runs.update(scans)
    for name, (kern, plain, lib, (bms, by)) in runs.items():
        r = rec[name]
        r["ms"] = time_ms(kern, flush)
        r["plain_ms"] = time_ms(plain, flush)
        r["library_ms"] = time_ms(lib, flush) if lib else None
        r["bound_ms"], r["bound_by"] = bms, by
        lib_s = "null" if lib is None else f"{r['library_ms']:.4f}"
        log(f"[time] {name:29} kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {lib_s} ms, bound "
            f"{bms * 1e3:.2f} us ({by}) — median of 30, L2 flushed")
    for name, fn in steps.items():
        log(f"[time] {name:35} {time_ms(fn, flush):.4f} ms — median of 30, "
            "L2 flushed before the first step")
    # beside the records (int8 codes, W_x): q1.11 (int16 codes), and the
    # single-family kernels on W_h
    extra = {f"{n} q1.11": v for n, v in q8_runs(torch, full,
                                                  spec="q1.11").items()}
    extra.update({f"{n} W_h": v for n, v in single_runs(
        torch, ops, full, "W_h").items()})
    for fam in ("W_x", "W_h"):
        extra[f"rb_spmv_q8 q1.11 {fam}"] = single_runs(
            torch, ops, full, fam, "q1.11")["rb_spmv_q8"]
    for name, (kern, plain, lib, (bms, by)) in extra.items():
        log(f"[time] {name:35} kernel {time_ms(kern, flush):.4f} ms, "
            f"plain {time_ms(plain, flush):.4f} ms, library "
            f"{time_ms(lib, flush):.4f} ms, bound {bms * 1e3:.2f} us "
            f"({by}) — median of 30, L2 flushed")
    gates_pair(full, flush)
    return rec


def gates_pair(cs, flush) -> None:
    """The chained float step's pair, rb_dual_spmv (B1) then lstm_gates
    (B2) on its z, in one event window after an L2 flush: B2 launched as
    B1's programmatic dependent (the serve loop's launch) against a plain
    launch, alternated twice and bitwise equal
    (``profile_kernels.profile_pair``)."""
    from repro_torch.launch.profile_kernels import profile_pair
    log("[time] rb_dual_spmv -> lstm_gates pair (the chained float step's "
        "kernels), lstm_gates launched as a programmatic dependent (pdl) "
        "and plainly, alternated; median of 30, L2 flushed:")
    t = profile_pair(cs["sx"], cs["sh"], cs["x"], cs["h"], cs["bias"],
                     cs["c"], flush)
    pdl = statistics.median(t[f"pair pdl #{r}"] for r in (1, 2))
    plain = statistics.median(t[f"pair plain #{r}"] for r in (1, 2))
    log(f"[time] pair: pdl {pdl:.4f} ms, plain {plain:.4f} ms, pdl - plain "
        f"{(pdl - plain) * 1e3:+.2f} us; the two give the same c and h bits")


def check_float(torch, ops, err, tag, cs):
    """rb_dual_spmv and lstm_gates against their plain versions, and the
    fused step against its plain version and bitwise equal to
    rb_dual_spmv -> lstm_gates, PWL off and on."""
    sx, sh, x, h, c, b, H = (cs[k] for k in
                             ("sx", "sh", "x", "h", "c", "bias", "H"))
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
        e = max(err("fused_brds_lstm_step", cf, cp, CELL_TOL, f"{tag} c"),
                err("fused_brds_lstm_step", hf, hp, CELL_TOL, f"{tag} h"))
        if not (torch.equal(cf, cc) and torch.equal(hf, hc)):
            raise AssertionError(f"fused step is not bitwise equal to the "
                                 f"chained kernels ({tag}, pwl={pwl})")
        log(f"  fused step     pwl={pwl!s:5} max|c,h err| {e:.3e} "
            f"(tol {CELL_TOL:.0e}); bitwise equal to chained kernels")


def check_delta(torch, ops, err, tag, cs):
    """delta_rb_dual_spmv and the fused delta step against their plain
    versions at a fired share of about 50% and 100%; fused bitwise equal
    to delta_rb_dual_spmv -> m + bias -> lstm_gates."""
    sx, sh, dx, dh, m, b, c = (cs[k] for k in ("sx", "sh", "dx", "dh", "m",
                                               "bias", "c"))
    for share, (fx, fh) in cs["fired"].items():
        args = (sx, dx, fx, sh, dh, fh, m)
        mk = ops.delta_rb_dual_spmv(*args, backend="cuda")
        mr = ops.delta_rb_dual_spmv(*args, backend="ref")
        torch.cuda.synchronize()
        e = err("delta_rb_dual_spmv", mk, mr, Z_TOL, f"{tag} {share}")
        log(f"  delta_rb_dual  fired {float(fx.mean()):.2f}/"
            f"{float(fh.mean()):.2f} max|m err| {e:.3e} (tol {Z_TOL:.0e})")
        for pwl in (False, True):
            kf = ops.fused_brds_delta_lstm_step(*args, b, c, pwl=pwl,
                                                backend="cuda")
            kc = ops.brds_delta_lstm_step(*args, b, c, pwl=pwl,
                                          backend="cuda")
            kp = ops.fused_brds_delta_lstm_step(*args, b, c, pwl=pwl,
                                                backend="ref")
            torch.cuda.synchronize()
            name = "fused_brds_delta_lstm_step"
            e = max(err(name, kf[0], kp[0], CELL_TOL, f"{tag} c"),
                    err(name, kf[1], kp[1], CELL_TOL, f"{tag} h"))
            em = err(name, kf[2], kp[2], Z_TOL, f"{tag} m")
            if not all(torch.equal(a, b_) for a, b_ in zip(kf, kc)):
                raise AssertionError(f"fused delta step is not bitwise equal "
                                     f"to the chained kernels ({tag}, "
                                     f"fired {share}, pwl={pwl})")
            log(f"  fused delta    pwl={pwl!s:5} max|c,h err| {e:.3e} "
                f"(tol {CELL_TOL:.0e}), max|m err| {em:.3e}; bitwise equal "
                "to chained kernels")


def check_q8(torch, ops, ref, kq8, err, tag, cs):
    """rb_dual_parts_q8 exactly equal to its plain version, the fused q8
    step within tolerance of its plain version and bitwise equal to
    rb_dual_parts_q8 -> zx + zh + bias -> lstm_gates, for int8 and q1.11
    codes."""
    x, h, b, c = cs["x"], cs["h"], cs["bias"], cs["c"]
    for spec in SCHEMES:
        qsx, qsh = cs["q8"][spec]
        qx, sax, qh, sah = q8_acts(cs, spec)
        zx, zh = kq8.rb_dual_parts_q8(qsx.values, qsx.deltas,
                                      qsx.scales * sax, qx, qsh.values,
                                      qsh.deltas, qsh.scales * sah, qh,
                                      qsx.rows)
        zxr, zhr = ref.rb_spmv_q8_ref(qsx, qx, sax), ref.rb_spmv_q8_ref(
            qsh, qh, sah)
        torch.cuda.synchronize()
        err("rb_dual_parts_q8", zx, zxr, 0.0, f"{tag} {spec} zx")
        err("rb_dual_parts_q8", zh, zhr, 0.0, f"{tag} {spec} zh")
        if not (torch.equal(zx, zxr) and torch.equal(zh, zhr)):
            raise AssertionError(f"rb_dual_parts_q8 differs from its plain "
                                 f"version ({tag}, {spec})")
        log(f"  rb_dual_parts_q8 {spec:5} codes {qsx.values.dtype}: zx, zh "
            "exactly equal to the plain version")
        kw = dict(act_scale_x=sax, act_scale_h=sah)
        for pwl in (False, True):
            args = (qsx, x, qsh, h, b, c)
            kf = ops.fused_brds_lstm_step_q8(*args, pwl=pwl, backend="cuda",
                                             **kw)
            kc = ops.brds_lstm_step_q8(*args, pwl=pwl, backend="cuda", **kw)
            kp = ops.fused_brds_lstm_step_q8(*args, pwl=pwl, backend="ref",
                                             **kw)
            torch.cuda.synchronize()
            name = "fused_brds_lstm_step_q8"
            e = max(err(name, kf[0], kp[0], CELL_TOL, f"{tag} {spec} c"),
                    err(name, kf[1], kp[1], CELL_TOL, f"{tag} {spec} h"))
            if not all(torch.equal(a, b_) for a, b_ in zip(kf, kc)):
                raise AssertionError(f"fused q8 step is not bitwise equal to "
                                     f"the chained kernels ({tag}, {spec}, "
                                     f"pwl={pwl})")
            log(f"  fused q8 {spec:5} pwl={pwl!s:5} max|c,h err| {e:.3e} "
                f"(tol {CELL_TOL:.0e}); bitwise equal to chained kernels")


def check_single(torch, ops, err, tag, cs):
    """The single-family kernels against their plain versions on both
    families: rb_spmv and delta_rb_spmv (fired about 50% and 100%, the
    mask given as bool once) within Z_TOL, rb_spmv_q8 exactly equal with a
    static and a dynamic activation scale; and rb_spmv(Sx, x) + rb_spmv(Sh,
    h) + bias bitwise equal to rb_dual_spmv, (m + delta_rb_spmv(Sx, dx,
    fx)) + delta_rb_spmv(Sh, dh, fh) bitwise equal to delta_rb_dual_spmv
    (row_dot's order in all four, and the same adds)."""
    from repro_torch.kernels import rb_spmv_q8 as kq8
    sx, sh, x, h, b, dx, dh = (cs[k] for k in ("sx", "sh", "x", "h", "bias",
                                               "dx", "dh"))
    ys = []
    for fam, s, v in (("Sx", sx, x), ("Sh", sh, h)):
        y = ops.rb_spmv(s, v, backend="cuda")
        e = err("rb_spmv", y, ops.rb_spmv(s, v, backend="ref"), Z_TOL,
                f"{tag} {fam}")
        ys.append(y)
        log(f"  rb_spmv        {fam} max|y err| {e:.3e} (tol {Z_TOL:.0e})")
    z = ops.rb_dual_spmv(sx, x, sh, h, b, backend="cuda")
    d = (ys[0] + ys[1] + b[:sx.rows]) - z
    log(f"  rb_spmv(Sx, x) + rb_spmv(Sh, h) + bias vs rb_dual_spmv: "
        f"max|diff| {d.abs().max().item():.3e} (must be 0: bitwise)")
    if not torch.equal(ys[0] + ys[1] + b[:sx.rows], z):
        raise AssertionError(f"rb_spmv(Sx, x) + rb_spmv(Sh, h) + bias is not "
                             f"bitwise rb_dual_spmv ({tag})")
    m = cs["m"]
    for share, (fx, fh) in cs["fired"].items():
        ys = []
        for fam, s, dv, f in (("Sx", sx, dx, fx.bool()), ("Sh", sh, dh, fh)):
            y = ops.delta_rb_spmv(s, dv, f, backend="cuda")
            e = err("delta_rb_spmv", y,
                    ops.delta_rb_spmv(s, dv, f, backend="ref"), Z_TOL,
                    f"{tag} {fam} {share}")
            ys.append(y)
            log(f"  delta_rb_spmv  {fam} fired {float(f.float().mean()):.2f} "
                f"max|y err| {e:.3e} (tol {Z_TOL:.0e})")
        dual = ops.delta_rb_dual_spmv(sx, dx, fx, sh, dh, fh, m,
                                      backend="cuda")
        chain = (m + ys[0]) + ys[1]
        log(f"  (m + delta_rb_spmv(Sx)) + delta_rb_spmv(Sh) vs "
            f"delta_rb_dual_spmv, fired {share}: max|diff| "
            f"{(chain - dual).abs().max().item():.3e} (must be 0: bitwise)")
        if not torch.equal(chain, dual):
            raise AssertionError(f"(m + delta_rb_spmv(Sx)) + delta_rb_spmv("
                                 f"Sh) is not bitwise delta_rb_dual_spmv "
                                 f"({tag}, fired {share})")
    for spec in SCHEMES:
        qsx, qsh = cs["q8"][spec]
        qx, sax, qh, sah = q8_acts(cs, spec)
        how = []
        for fam, q, v, qv, sa in (("Sx", qsx, x, qx, sax),
                                  ("Sh", qsh, h, qh, sah)):
            for scale in (sa, None):
                y = ops.rb_spmv_q8(q, v, act_scale=scale, backend="cuda")
                yr = ops.rb_spmv_q8(q, v, act_scale=scale, backend="ref")
                torch.cuda.synchronize()
                err("rb_spmv_q8", y, yr, 0.0, f"{tag} {spec} {fam}")
                if not torch.equal(y, yr):
                    raise AssertionError(f"rb_spmv_q8 differs from its plain "
                                         f"version ({tag}, {spec}, {fam})")
            p = kq8.single_q8_plan_for(q.values, qv, q.rows)
            how.append(f"{fam} {q.deltas.dtype} deltas, codes "
                       + ("staged" if p.staged else "gathered"))
        log(f"  rb_spmv_q8 {spec:5} ({'; '.join(how)}), static and dynamic "
            "act scale: exactly equal to the plain version")


def check_delta_q8(torch, ops, err, tag, cs):
    """The fused delta-q8 step against its plain version (m' exactly
    equal, c and h within CELL_TOL) and bitwise against the chained
    rb_dual_parts_q8 -> m + zx + zh -> + bias -> lstm_gates, for int8 and
    q1.11 codes, fired about 50% and 100%, PWL off and on. The activation
    scales are the static ones doubled, as the model doubles them for
    deltas."""
    dx, dh, m, b, c = (cs[k] for k in ("dx", "dh", "m", "bias", "c"))
    name = "fused_brds_delta_lstm_step_q8"
    for spec in SCHEMES:
        qsx, qsh = cs["q8"][spec]
        _, sax, _, sah = q8_acts(cs, spec)
        kw = dict(act_scale_x=2 * sax, act_scale_h=2 * sah)
        for share, (fx, fh) in cs["fired"].items():
            args = (qsx, dx, fx, qsh, dh, fh, m, b, c)
            for pwl in (False, True):
                kf = ops.fused_brds_delta_lstm_step_q8(*args, pwl=pwl,
                                                       backend="cuda", **kw)
                kc = ops.brds_delta_lstm_step_q8(*args, pwl=pwl,
                                                 backend="cuda", **kw)
                kp = ops.fused_brds_delta_lstm_step_q8(*args, pwl=pwl,
                                                       backend="ref", **kw)
                torch.cuda.synchronize()
                e = max(err(name, kf[0], kp[0], CELL_TOL, f"{tag} {spec} c"),
                        err(name, kf[1], kp[1], CELL_TOL, f"{tag} {spec} h"))
                err(name, kf[2], kp[2], 0.0, f"{tag} {spec} m")
                if not torch.equal(kf[2], kp[2]):
                    raise AssertionError(f"fused delta-q8 m' differs from "
                                         f"its plain version ({tag}, {spec})")
                if not all(torch.equal(u, v) for u, v in zip(kf, kc)):
                    raise AssertionError(
                        f"fused delta-q8 step is not bitwise equal to the "
                        f"chained kernels ({tag}, {spec}, fired {share}, "
                        f"pwl={pwl})")
                log(f"  fused dq8 {spec:5} fired {share} pwl={pwl!s:5} "
                    f"max|c,h err| {e:.3e} (tol {CELL_TOL:.0e}), m' exactly "
                    "equal; bitwise equal to chained kernels")


def check_batch_tiles(torch, ops, err):
    """B=64 at full width: every row-balanced kernel and both scans once
    on the whole batch and once on each 16-row tile, the tiles' outputs
    concatenated bitwise equal to the whole's, and the whole within
    tolerance of the plain version (the q8 sums exactly). Activation
    codes use static scales, which do not depend on the batch."""
    from repro_torch.kernels import rb_spmv_q8 as kq8
    B, T = 64, 16
    cs = make_case(torch, torch.device("cuda"), B=B, X=1500, H=1500,
                   spar_x=0.75, spar_h=0.5, seed=5)
    sx, sh, b, H = cs["sx"], cs["sh"], cs["bias"], cs["H"]
    fx, fh = cs["fired"][0.5]
    qsx, qsh = cs["q8"]["int8"]
    qx, sax, qh, sah = q8_acts(cs, "int8")
    z = ops.rb_dual_spmv(sx, cs["x"], sh, cs["h"], b, backend="ref")
    rows = {"x": cs["x"], "h": cs["h"], "c": cs["c"], "dx": cs["dx"],
            "dh": cs["dh"], "fx": fx, "fh": fh, "m": cs["m"], "qx": qx,
            "qh": qh, "z": z, "x_ref": cs["x_ref"], "h_ref": cs["h_ref"]}
    q8 = dict(act_scale_x=sax, act_scale_h=sah)
    dq8 = dict(act_scale_x=2 * sax, act_scale_h=2 * sah)
    # name: (run on batch rows r (a dict of the row-sliced tensors, xs at
    # dim 1), the batch dim of each output, each output's tolerance
    # against the plain version, as phase 2 holds them)
    cases = {
        "rb_dual_spmv": (lambda r, be: (ops.rb_dual_spmv(
            sx, r["x"], sh, r["h"], b, backend=be),), (0,), Z_TOL),
        "lstm_gates": (lambda r, be: ops.lstm_gates(
            *(r["z"][:, i * H:(i + 1) * H] for i in range(4)), r["c"],
            backend=be), (0, 0), CELL_TOL),
        "fused_brds_lstm_step": (lambda r, be: ops.fused_brds_lstm_step(
            sx, r["x"], sh, r["h"], b, r["c"], backend=be), (0, 0),
            CELL_TOL),
        "delta_rb_dual_spmv": (lambda r, be: (ops.delta_rb_dual_spmv(
            sx, r["dx"], r["fx"], sh, r["dh"], r["fh"], r["m"],
            backend=be),), (0,), Z_TOL),
        "fused_brds_delta_lstm_step": (
            lambda r, be: ops.fused_brds_delta_lstm_step(
                sx, r["dx"], r["fx"], sh, r["dh"], r["fh"], r["m"], b,
                r["c"], backend=be), (0, 0, 0), (CELL_TOL, CELL_TOL, Z_TOL)),
        "rb_dual_parts_q8": (
            lambda r, be: kq8.rb_dual_parts_q8(
                qsx.values, qsx.deltas, qsx.scales * sax, r["qx"],
                qsh.values, qsh.deltas, qsh.scales * sah, r["qh"], qsx.rows)
            if be == "cuda" else (ref_q8(qsx, r["qx"], sax),
                                  ref_q8(qsh, r["qh"], sah)), (0, 0), 0.0),
        "fused_brds_lstm_step_q8": (lambda r, be: ops.fused_brds_lstm_step_q8(
            qsx, r["x"], qsh, r["h"], b, r["c"], backend=be, **q8), (0, 0),
            CELL_TOL),
        "fused_brds_delta_lstm_step_q8": (
            lambda r, be: ops.fused_brds_delta_lstm_step_q8(
                qsx, r["dx"], r["fx"], qsh, r["dh"], r["fh"], r["m"], b,
                r["c"], backend=be, **dq8), (0, 0, 0), (CELL_TOL, CELL_TOL,
                                                         0.0)),
        "rb_spmv": (lambda r, be: (ops.rb_spmv(sx, r["x"], backend=be),),
                    (0,), Z_TOL),
        "rb_spmv_q8": (lambda r, be: (ops.rb_spmv_q8(
            qsx, r["x"], act_scale=sax, backend=be),), (0,), 0.0),
        "delta_rb_spmv": (lambda r, be: (ops.delta_rb_spmv(
            sx, r["dx"], r["fx"], backend=be),), (0,), Z_TOL),
        "fused_brds_lstm_scan": (lambda r, be: ops.fused_brds_lstm_scan(
            sx, r["xs"], sh, r["h"], b, r["c"], backend=be), (1, 0),
            CELL_TOL),
        "fused_brds_delta_lstm_scan": (
            lambda r, be: ops.fused_brds_delta_lstm_scan(
                sx, r["xs"], sh, r["h"], r["c"], r["x_ref"], r["h_ref"],
                r["m"], b, theta_x=0.0, theta_h=0.0, backend=be),
            (1, 0, 0, 0, 0), Z_TOL),
    }

    def rows_of(sl):
        r = {k: v[sl] for k, v in rows.items()}
        r["xs"] = cs["xs"][:, sl].contiguous()
        return r

    log(f"[kernels] B={B}: X={cs['X']} H={H}, the whole batch against its "
        f"{B // T} tiles of {T} rows")
    for name, (run, dims, tol) in cases.items():
        tols = tol if isinstance(tol, tuple) else (tol,) * len(dims)
        whole = run(rows_of(slice(None)), "cuda")
        tiles = [run(rows_of(slice(t, t + T)), "cuda")
                 for t in range(0, B, T)]
        plain = run(rows_of(slice(None)), "ref")
        torch.cuda.synchronize()
        errs = []
        for i, (d, tl) in enumerate(zip(dims, tols)):
            cat = torch.cat([part[i] for part in tiles], d)
            if not torch.equal(cat, whole[i]):
                raise AssertionError(f"{name} at B={B}: output {i} is not "
                                     f"bitwise its {B // T} tiles of {T}")
            errs.append(err(name, whole[i], plain[i], tl,
                            f"B={B} output {i}"))
        log(f"  {name:29} B={B}: bitwise equal to its {T}-row tiles; "
            f"max|err| vs plain {max(errs):.3e} (tol "
            f"{', '.join(f'{t:.0e}' for t in tols)})")
    # at Θ = 0.05 a delta within float noise of Θ can fire on one side
    # and not the other over 64 x 1500 x 32 decisions
    check_delta_chain(torch, ops, err, f"B={B}", cs)


def ref_q8(s, q, scale):
    from repro_torch.kernels import ref
    return ref.rb_spmv_q8_ref(s, q, scale)


def delta_steps(torch, ops, cs, theta, pwl=False, backend="cuda",
                decisions=None):
    """T × (delta_threshold on x and on h → the fused delta step kernel, or
    its plain version with ``backend="ref"``): what the delta scan must
    equal. Each step's (|dx|, fx, |dh|, fh) goes to ``decisions`` when
    given. Returns (hs, c, x_ref, h_ref, m)."""
    from repro_torch.sparse.temporal import delta_threshold
    sx, sh, b = cs["sx"], cs["sh"], cs["bias"]
    c, h, xr, hr, m = (cs[k] for k in ("c", "h", "x_ref", "h_ref", "m"))
    hs = []
    for x in cs["xs"]:
        dx, fx, xr = delta_threshold(x, xr, theta)
        dh, fh, hr = delta_threshold(h, hr, theta)
        if decisions is not None:
            decisions.append((dx.abs(), fx, dh.abs(), fh))
        c, h, m = ops.fused_brds_delta_lstm_step(sx, dx, fx, sh, dh, fh, m,
                                                 b, c, pwl=pwl,
                                                 backend=backend)
        hs.append(h)
    return torch.stack(hs), c, xr, hr, m


def check_tile_scans(torch, ops, err, cs):
    """Both scans at a batch of one full tile (B=16, full width): the
    float scan bitwise equal to T fused-step launches and within
    CELL_TOL of its plain version; the delta scan at Θ = 0 bitwise equal
    to its chain and within Z_TOL of its plain version, and at Θ = 0.05
    as ``check_delta_chain`` holds it."""
    sx, sh, xs, h0, c0, b = (cs[k] for k in ("sx", "sh", "xs", "h", "c",
                                             "bias"))
    T, B = xs.shape[:2]
    tag = f"B={B}"
    got = ops.fused_brds_lstm_scan(sx, xs, sh, h0, b, c0, backend="cuda")
    c, h, hs = c0, h0, []
    for x in xs:
        c, h = ops.fused_brds_lstm_step(sx, x, sh, h, b, c, backend="cuda")
        hs.append(h)
    plain = ops.fused_brds_lstm_scan(sx, xs, sh, h0, b, c0, backend="ref")
    torch.cuda.synchronize()
    name = "fused_brds_lstm_scan"
    e = max(err(name, got[0], plain[0], CELL_TOL, f"{tag} hs"),
            err(name, got[1], plain[1], CELL_TOL, f"{tag} c"))
    if not (torch.equal(got[0], torch.stack(hs)) and torch.equal(got[1], c)):
        raise AssertionError(f"scan is not bitwise equal to {T} fused steps "
                             f"({tag})")
    log(f"  {name:29} {tag}: bitwise equal to {T} fused-step launches; "
        f"max|hs,c err| {e:.3e} (tol {CELL_TOL:.0e})")
    args = (sx, xs, sh, h0, c0, cs["x_ref"], cs["h_ref"], cs["m"], b)
    got = ops.fused_brds_delta_lstm_scan(*args, theta_x=0.0, theta_h=0.0,
                                         backend="cuda")
    want = delta_steps(torch, ops, cs, 0.0)
    plain = ops.fused_brds_delta_lstm_scan(*args, theta_x=0.0, theta_h=0.0,
                                           backend="ref")
    torch.cuda.synchronize()
    name = "fused_brds_delta_lstm_scan"
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"delta scan is not bitwise equal to {T} × "
                             f"(thresholds → fused delta step) ({tag}, Θ=0)")
    e = max(err(name, g, p_, Z_TOL, f"{tag} {what} Θ=0")
            for g, p_, what in zip(got, plain, ("hs", "c", "x_ref", "h_ref",
                                                "m")))
    log(f"  {name:29} {tag} Θ=0: bitwise equal to {T} x (thresholds → "
        f"fused delta step); max|err| vs plain {e:.3e} (tol {Z_TOL:.0e})")
    check_delta_chain(torch, ops, err, tag, cs)


def check_delta_chain(torch, ops, err, tag, cs, theta=0.05):
    """The delta scan at Θ > 0, bitwise equal to T × (thresholds → fused
    delta step). Against the plain version it is held to Z_TOL unless a
    threshold decision flipped: the plain chain (T × (thresholds → plain
    fused delta step)) first fires otherwise than the kernels' at some
    step, the two agree within Z_TOL before it, and every decision that
    differs there has |d| within Z_TOL of Θ (the float noise of z's order,
    carried into h, tips it). A flip changes the trajectory from that
    step on, so the plain version is no reference from there; a differing
    decision away from Θ fails."""
    args = (cs["sx"], cs["xs"], cs["sh"], cs["h"], cs["c"], cs["x_ref"],
            cs["h_ref"], cs["m"], cs["bias"])
    got = ops.fused_brds_delta_lstm_scan(*args, theta_x=theta,
                                         theta_h=theta, backend="cuda")
    kd, pd = [], []
    want = delta_steps(torch, ops, cs, theta, decisions=kd)
    plain = ops.fused_brds_delta_lstm_scan(*args, theta_x=theta,
                                           theta_h=theta, backend="ref")
    delta_steps(torch, ops, cs, theta, backend="ref", decisions=pd)
    torch.cuda.synchronize()
    T, B = cs["xs"].shape[:2]
    name = "fused_brds_delta_lstm_scan"
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"delta scan at B={B}, Θ={theta}, is not "
                             f"bitwise {T} x (thresholds → fused delta "
                             "step)")
    diff = max((g - p_).abs().max().item() for g, p_ in zip(got, plain))
    flip = next((t for t, (k, p_) in enumerate(zip(kd, pd))
                 if not (torch.equal(k[1], p_[1])
                         and torch.equal(k[3], p_[3]))), None)
    if flip is None:
        e = max(err(name, g, p_, Z_TOL, f"{tag} {what} Θ={theta}")
                for g, p_, what in zip(got, plain, ("hs", "c", "x_ref",
                                                    "h_ref", "m")))
        why = f"max|err| vs plain {e:.3e} (tol {Z_TOL:.0e}), no flip"
    else:
        near = 0.0
        for a, f in ((0, 1), (2, 3)):
            k, p_ = kd[flip], pd[flip]
            at = k[f] != p_[f]
            if at.any():
                near = max(near, (k[a][at] - theta).abs().max().item())
        if not near <= Z_TOL:
            raise AssertionError(
                f"delta scan at B={B}, Θ={theta}: the plain chain first "
                f"fires otherwise at step {flip}, at |d| {near:.3e} from Θ "
                f"(> {Z_TOL:.0e}): not a threshold flip")
        if flip:
            err(name, got[0][:flip], plain[0][:flip], Z_TOL,
                f"{tag} hs before the flip at step {flip}, Θ={theta}")
        why = (f"max|diff| vs plain {diff:.3e}: a threshold decision "
               f"flips at step {flip} of {T}, |d| within {near:.3e} of Θ "
               f"(≤ {Z_TOL:.0e}), and the trajectories part there")
    log(f"  {name:29} B={B} Θ={theta}: bitwise equal to {T} x "
        f"(thresholds → fused delta step); {why}")


def check_scans(torch, ops, err, tag, cs):
    """The multi-token scans over T steps: bitwise equal to T launches of
    their single-step kernels (the delta scan to T × (thresholds → fused
    delta step)), and against their plain versions, with PWL off and on;
    the delta scan at Θ = 0 and 0.05."""
    sx, sh, xs, h0, c0, b = (cs[k] for k in ("sx", "sh", "xs", "h", "c",
                                             "bias"))
    T = xs.shape[0]
    for pwl in (False, True):
        got = ops.fused_brds_lstm_scan(sx, xs, sh, h0, b, c0, pwl=pwl,
                                       backend="cuda")
        c, h, hs = c0, h0, []
        for x in xs:
            c, h = ops.fused_brds_lstm_step(sx, x, sh, h, b, c, pwl=pwl,
                                            backend="cuda")
            hs.append(h)
        plain = ops.fused_brds_lstm_scan(sx, xs, sh, h0, b, c0, pwl=pwl,
                                         backend="ref")
        torch.cuda.synchronize()
        name = "fused_brds_lstm_scan"
        e = max(err(name, got[0], plain[0], CELL_TOL, f"{tag} hs"),
                err(name, got[1], plain[1], CELL_TOL, f"{tag} c"))
        if not (torch.equal(got[0], torch.stack(hs))
                and torch.equal(got[1], c)):
            raise AssertionError(f"scan is not bitwise equal to {T} fused "
                                 f"steps ({tag}, pwl={pwl})")
        log(f"  scan T={T}      pwl={pwl!s:5} max|hs,c err| {e:.3e} (tol "
            f"{CELL_TOL:.0e}); bitwise equal to {T} fused-step launches")
        for theta in (0.0, 0.05):
            args = (sx, xs, sh, h0, c0, cs["x_ref"], cs["h_ref"], cs["m"], b)
            kw = dict(theta_x=theta, theta_h=theta, pwl=pwl)
            got = ops.fused_brds_delta_lstm_scan(*args, backend="cuda", **kw)
            want = delta_steps(torch, ops, cs, theta, pwl)
            plain = ops.fused_brds_delta_lstm_scan(*args, backend="ref",
                                                   **kw)
            torch.cuda.synchronize()
            name = "fused_brds_delta_lstm_scan"
            # m is a running sum of T steps of products added in another
            # order than the plain version's, and the cell and the
            # references read it: z's tolerance for every output
            e = max(err(name, g, p_, Z_TOL, f"{tag} {what} Θ={theta}")
                    for g, p_, what in zip(got, plain, ("hs", "c", "x_ref",
                                                        "h_ref", "m")))
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(
                    f"delta scan is not bitwise equal to {T} × (thresholds "
                    f"→ fused delta step) ({tag}, Θ={theta}, pwl={pwl})")
            log(f"  delta scan T={T} Θ={theta:<4} pwl={pwl!s:5} "
                f"max|hs,c,refs,m err| {e:.3e} (tol {Z_TOL:.0e}); bitwise "
                f"equal to {T} × (thresholds → fused delta step)")


def scan_runs(torch, ops, cs, wx, wh):
    """Timing entries of the scans at the serve shapes over T = the serve
    prompt (the delta scan at Θ = 0: every column of these random inputs
    fires), and the T single-step launches each replaces. The float scan's
    library call is one cuDNN LSTM over the T steps on the dense
    (unpacked) weights, gate rows permuted from (f, i, g, o) to PyTorch's
    (i, f, g, o); the delta scan has none."""
    B, H, X = cs["B"], cs["H"], cs["X"]
    sx, sh, xs, h0, c0, b = (cs[k] for k in ("sx", "sh", "xs", "h", "c",
                                             "bias"))
    T = xs.shape[0]
    dargs = (sx, xs, sh, h0, c0, cs["x_ref"], cs["h_ref"], cs["m"], b)
    weights = packed_bytes(sx) + packed_bytes(sh)
    step_flops = 2 * B * (sx.rows * sx.K + sh.rows * sh.K) + 30 * B * H
    state = nbytes(h0, c0, b) + nbytes(c0) + T * nbytes(h0)   # in and out

    def ifgo(w):
        return torch.cat([w[H:2 * H], w[:H], w[2 * H:]])

    torch.backends.cudnn.allow_tf32 = False
    lstm = torch.nn.LSTM(X, H, device=xs.device)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(ifgo(wx))
        lstm.weight_hh_l0.copy_(ifgo(wh))
        lstm.bias_ih_l0.copy_(ifgo(b))
        lstm.bias_hh_l0.zero_()
    lstm.flatten_parameters()

    def cudnn():
        with torch.no_grad():
            return lstm(xs, (h0[None], c0[None]))

    hs_lib, (_, c_lib) = cudnn()
    hs, c = ops.fused_brds_lstm_scan(sx, xs, sh, h0, b, c0, backend="cuda")
    diff = max((hs_lib - hs).abs().max().item(),
               (c_lib[0] - c).abs().max().item())
    log(f"  cuDNN LSTM (the scan's library call) vs the scan: max|hs, c "
        f"diff| {diff:.3e}")

    def steps():
        c, h = c0, h0
        for x in xs:
            c, h = ops.fused_brds_lstm_step(sx, x, sh, h, b, c,
                                            backend="cuda")

    runs = {
        "fused_brds_lstm_scan": (
            lambda: ops.fused_brds_lstm_scan(sx, xs, sh, h0, b, c0,
                                             backend="cuda"),
            lambda: ops.fused_brds_lstm_scan(sx, xs, sh, h0, b, c0,
                                             backend="ref"),
            cudnn,
            bound(weights + nbytes(xs) + state, T * step_flops)),
        "fused_brds_delta_lstm_scan": (
            lambda: ops.fused_brds_delta_lstm_scan(
                *dargs, theta_x=0.0, theta_h=0.0, backend="cuda"),
            lambda: ops.fused_brds_delta_lstm_scan(
                *dargs, theta_x=0.0, theta_h=0.0, backend="ref"),
            None,
            bound(weights + nbytes(xs) + state
                  + 2 * nbytes(cs["x_ref"], cs["h_ref"], cs["m"]),
                  T * (step_flops + 2 * B * sx.rows + 6 * B * (X + H)))),
    }
    step_runs = {
        f"{T} launches of fused_brds_lstm_step": steps,
        f"{T} x (thresholds + fused delta step)":
            lambda: delta_steps(torch, ops, cs, 0.0),
    }
    return runs, step_runs


def delta_runs(torch, ops, cs, wxT, whT):
    """Timing entries of the delta kernels at the serve shapes, every
    column fired (the Θ = 0 serve path fires nearly all of them)."""
    B, H = cs["B"], cs["H"]
    sx, sh, dx, dh, m, b, c = (cs[k] for k in ("sx", "sh", "dx", "dh", "m",
                                               "bias", "c"))
    fx, fh = cs["fired"][1.0]
    args = (sx, dx, fx, sh, dh, fh, m)
    weights = packed_bytes(sx) + packed_bytes(sh)
    flops = 2 * B * (sx.rows * sx.K + sh.rows * sh.K) + 2 * B * sx.rows

    def addmm_pair():
        torch.addmm(torch.addmm(m, dx * fx, wxT), dh * fh, whT)

    return {
        "delta_rb_dual_spmv": (
            lambda: ops.delta_rb_dual_spmv(*args, backend="cuda"),
            lambda: ops.delta_rb_dual_spmv(*args, backend="ref"),
            addmm_pair,
            bound(weights + nbytes(dx, fx, dh, fh, m) + nbytes(m), flops)),
        "fused_brds_delta_lstm_step": (
            lambda: ops.fused_brds_delta_lstm_step(*args, b, c,
                                                   backend="cuda"),
            lambda: ops.fused_brds_delta_lstm_step(*args, b, c,
                                                   backend="ref"),
            addmm_pair,
            bound(weights + nbytes(dx, fx, dh, fh, m, b, c) + nbytes(m)
                  + 2 * nbytes(c), flops + 30 * B * H)),
    }


def q8_runs(torch, cs, spec="int8"):
    """Timing entries of the q8 kernels at the serve shapes: the kernel
    wrappers on codes quantized beforehand, the plain versions on the same
    codes, and the dense float32 addmm pair on the dequantized weights
    (``torch._int_mm`` needs more than 16 rows: no integer library call
    serves B=8)."""
    from repro_torch.core import unpack
    from repro_torch.kernels import ref
    from repro_torch.kernels import fused_step as kfused
    from repro_torch.kernels import rb_spmv_q8 as kq8
    from repro_torch.kernels.ops import _masked_codes as ops_masked_codes
    from repro_torch.quant import dequantize_packed
    B, H = cs["B"], cs["H"]
    b, c = cs["bias"], cs["c"]
    qsx, qsh = cs["q8"][spec]
    qx, sax, qh, sah = q8_acts(cs, spec)
    cx, ch = qsx.scales * sax, qsh.scales * sah
    wxT = unpack(dequantize_packed(qsx)).T.contiguous()
    whT = unpack(dequantize_packed(qsh)).T.contiguous()
    x, h = cs["x"], cs["h"]
    R = qsx.rows
    weights = packed_bytes(qsx) + packed_bytes(qsh)
    int_ops = 2 * B * (qsx.rows * qsx.K + qsh.rows * qsh.K)
    parts = (qsx.values, qsx.deltas, cx, qx, qsh.values, qsh.deltas, ch, qh)

    def addmm_pair():
        torch.addmm(torch.addmm(b, x, wxT), h, whT)

    def plain_parts():
        return ref.rb_spmv_q8_ref(qsx, qx, sax), ref.rb_spmv_q8_ref(qsh, qh,
                                                                    sah)

    # the fused delta-q8 step on the codes of the masked deltas, every
    # column fired (the Θ = 0 serve path), scales doubled as for deltas
    dx, dh, m = cs["dx"], cs["dh"], cs["m"]
    fx, fh = cs["fired"][1.0]
    qdx, sdx, qdh, sdh = ops_masked_codes(dx, fx, qsx, 2 * sax, dh, fh, qsh,
                                          2 * sah)
    dparts = (qsx.values, qsx.deltas, qsx.scales * sdx, qdx, qsh.values,
              qsh.deltas, qsh.scales * sdh, qdh)

    def delta_addmm_pair():
        torch.addmm(torch.addmm(m, dx * fx, wxT), dh * fh, whT)

    def delta_plain():
        mp = ref.delta_rb_dual_spmv_q8_ref(qsx, qdx, sdx, qsh, qdh, sdh, m)
        return cell(mp + b[None, :], c)

    return {
        "rb_dual_parts_q8": (
            lambda: kq8.rb_dual_parts_q8(*parts, R),
            plain_parts, addmm_pair,
            bound(weights + nbytes(qx, qh) + 2 * B * R * 4, 2 * B * R,
                  int_ops)),
        "fused_brds_lstm_step_q8": (
            lambda: kfused.fused_brds_lstm_step_q8(*parts, b, c),
            lambda: cell(ref.rb_dual_spmv_q8_ref(
                qsx, qx, sax, qsh, qh, sah, b), c),
            addmm_pair,
            bound(weights + nbytes(qx, qh, b, c) + 2 * nbytes(c),
                  4 * B * R + 30 * B * H, int_ops)),
        "fused_brds_delta_lstm_step_q8": (
            lambda: kfused.fused_brds_delta_lstm_step_q8(*dparts, m, b, c),
            delta_plain, delta_addmm_pair,
            bound(weights + nbytes(qdx, qdh, m, b, c) + nbytes(m)
                  + 2 * nbytes(c), 5 * B * R + 30 * B * H, int_ops)),
    }


def single_runs(torch, ops, cs, fam, spec="int8"):
    """Timing entries of the single-family kernels on one packed family
    (``fam`` "W_x" or "W_h") at the serve shapes: rb_spmv, rb_spmv_q8 on
    ``spec`` codes quantized beforehand, and delta_rb_spmv with every
    column fired; the library call is one dense torch.mm on the unpacked
    (for q8, dequantized) weights."""
    from repro_torch.core import unpack
    from repro_torch.kernels import ref
    from repro_torch.kernels import rb_spmv_q8 as kq8
    from repro_torch.quant import dequantize_packed
    i = 0 if fam == "W_x" else 1
    B = cs["B"]
    s = (cs["sx"], cs["sh"])[i]
    v = (cs["x"], cs["h"])[i]
    d = (cs["dx"], cs["dh"])[i]
    f = cs["fired"][1.0][i]
    q = cs["q8"][spec][i]
    qv, sa = q8_acts(cs, spec)[2 * i:2 * i + 2]
    comb = q.scales * sa
    wT = unpack(s).T.contiguous()
    qwT = unpack(dequantize_packed(q)).T.contiguous()
    R = s.rows
    out = B * R * 4
    flops = 2 * B * R * s.K
    return {
        "rb_spmv": (
            lambda: ops.rb_spmv(s, v, backend="cuda"),
            lambda: ops.rb_spmv(s, v, backend="ref"),
            lambda: torch.mm(v, wT),
            bound(packed_bytes(s) + nbytes(v) + out, flops)),
        "rb_spmv_q8": (
            lambda: kq8.rb_spmv_q8(q.values, q.deltas, comb, qv, R),
            lambda: ref.rb_spmv_q8_ref(q, qv, sa),
            lambda: torch.mm(v, qwT),
            bound(packed_bytes(q) + nbytes(qv) + out, B * R, flops)),
        "delta_rb_spmv": (
            lambda: ops.delta_rb_spmv(s, d, f, backend="cuda"),
            lambda: ops.delta_rb_spmv(s, d, f, backend="ref"),
            lambda: torch.mm(d * f, wT),
            bound(packed_bytes(s) + nbytes(d, f) + out, flops)),
    }


def teacher_forced(torch, model, params, seq):
    """Logits after each position of ``seq`` (B, T) through decode_step."""
    cache = model.init_cache(seq.shape[0], seq.shape[1], seq.device)
    out = []
    for t in range(seq.shape[1] - 1):
        logits, cache = model.decode_step(params, cache, seq[:, t:t + 1], t)
        out.append(logits[:, 0])
    return torch.stack(out, 1)


def timed_call(torch, times: list, run):
    """``run()``'s result; its host-clock seconds, synchronized, appended
    to ``times``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    times.append(time.perf_counter() - t0)
    return out


def timed_runs(torch, run, runs: int = RUNS) -> list[float]:
    """Host-clock seconds of ``runs`` calls of ``run``, each ended by a
    synchronize."""
    out = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


class Span(NamedTuple):
    start: float            # µs
    end: float


class DeviceEvent(NamedTuple):
    """A kernel, copy or set the profiler saw on the card: the ``name`` and
    ``time_range`` of its ``prof.events()`` record."""
    name: str
    time_range: Span


def device_events(torch, prof) -> list[DeviceEvent]:
    """The card's records of a finished ``prof``, read from the profiler's
    raw results with ``prof.events()``'s names (demangled) and filters
    (hidden events and user annotations dropped). ``prof.events()`` itself
    builds a Python event tree of every record first, ~60 µs a record:
    tens of seconds for one generate of a full-depth plain model."""
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    names: dict[str, str] = {}
    out = []
    for e in res.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA or \
                e.is_user_annotation() or \
                getattr(e, "is_hidden_event", lambda: False)():
            continue
        raw = e.name()
        name = names.get(raw)
        if name is None:
            name = names[raw] = torch._C._demangle(raw) if len(raw) > 1 \
                else raw
        start = e.start_ns() - t0
        out.append(DeviceEvent(name, Span(start / 1e3,
                                          (start + e.duration_ns()) / 1e3)))
    return out


def device_busy(torch, run, host_ops=True):
    """(device busy seconds, device span seconds) of one ``run`` under
    torch.profiler: the sum of the card's kernel and copy intervals, and
    their union (which a programmatic dependent's overlap does not
    inflate). Also returns the device events. ``host_ops`` False records
    the card's activity alone, which costs the host far less."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA]
    if host_ops:
        acts.append(ProfilerActivity.CPU)
    with profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    ev = device_events(torch, prof)
    spans = sorted((e.time_range.start, e.time_range.end) for e in ev)
    busy = sum(t - s for s, t in spans) / 1e6
    union, end = 0.0, float("-inf")
    for s, t in spans:
        if t > end:
            union += t - max(s, end)
            end = t
    return busy, union / 1e6, ev


def by_symbol(got, ev) -> tuple[dict, dict]:
    """(the profiler's kernel records in ``ev``, the launches its wrappers
    counted in ``got``), both per group of ``KERNEL_SYMBOLS`` that either
    has."""
    seen, counted = {}, {}
    for syms, ks in KERNEL_SYMBOLS:
        res = [re.compile(rf"(?<![A-Za-z_]){s}(?![a-z_])") for s in syms]
        n = sum(1 for e in ev if any(r.search(e.name) for r in res))
        c = sum(got.get(k, 0) for k in ks)
        if n or c:
            seen["/".join(ks)], counted["/".join(ks)] = n, c
    return seen, counted


def witnessed(torch, ops, tag, run, host_ops=True, tries=3):
    """``run`` under the profiler with every launch count set to 0 just
    before it and read just after: the counts (the captured loops' are
    their capture's, added again at each replay) held to the kernel
    records the profiler saw, by symbol. The profiler drops a record now
    and then (1-2 of 96-11016 in a few of my chip runs), so a run that saw
    fewer is profiled again, up to ``tries`` runs; one that saw more, or
    no exact one, fails. Returns (device busy s, span s, the profiler's
    counts, runs taken, its device events) of the exact run."""
    runs = []
    for i in range(tries):
        counted = {}

        def go():
            zero_launches(ops)
            run()
            torch.cuda.synchronize()
            counted.update(ops.LAUNCHES)

        busy, span, ev = device_busy(torch, go, host_ops)
        seen, want = by_symbol(counted, ev)
        if seen == want:
            return busy, span, seen, i + 1, ev
        runs.append(seen)
        if any(seen[k] > want[k] for k in want):
            break
    raise AssertionError(f"{tag}: the wrappers counted {want} launches, "
                         f"the profiler saw {runs}")


def host_loop(eng, packed, tokens, G, extra=None):
    """``generate``'s prefill (with the family's conditioning ``extra``),
    then the host loop the captured decode graph replaced
    (``runtime.decode_loop_eager``)."""
    from repro_torch.serving import SamplingConfig, runtime
    kw = {} if extra is None else {"extra": extra}
    logits, cache = eng.model.prefill(packed, tokens, eng.max_len, **kw)
    return runtime.decode_loop_eager(eng.model, packed, cache, logits,
                                     tokens.shape[1], None, G,
                                     SamplingConfig(), limit=eng.max_len)


def versus_host_loop(torch, tag, eng, packed, tokens, out, state, runs=3):
    """The captured loop's tokens and final state (cache, logits, pos,
    done, emitted) bitwise the host loop's from the same prompt; wall /
    step (median of ``runs``) and device busy / step (one profiled run)
    of both, over prompt + gen steps. Appends the row to GRAPH_ROWS."""
    from repro_torch.kernels import ops
    from repro_torch.serving import runtime
    G = out.shape[1]
    steps = tokens.shape[1] + G
    h_out, h_state = host_loop(eng, packed, tokens, G)
    same = bool(torch.equal(out, h_out)) and all(
        torch.equal(a, b) for a, b in zip(runtime.leaves(state),
                                          runtime.leaves(h_state)))
    if not same:
        raise AssertionError(f"{tag}: the captured decode loop differs from "
                             "the host loop")
    cap = lambda: eng.generate(packed, tokens, G)
    host = lambda: host_loop(eng, packed, tokens, G)
    # the decode loops alone, from one prefill (the LSTM's cache is not
    # written in place, so every run starts from the same state)
    from repro_torch.serving import SamplingConfig
    logits, cache = eng.model.prefill(packed, tokens, eng.max_len)
    args = (eng.model, packed, cache, logits, tokens.shape[1], None, G,
            SamplingConfig())
    decode = {"captured": lambda: runtime.decode_loop(
                  *args, limit=eng.max_len, graphs=eng.graphs),
              "host": lambda: runtime.decode_loop_eager(*args,
                                                        limit=eng.max_len)}
    row = {"path": tag, "batch": tokens.shape[0]}
    seen, tries = {}, {}
    for name, run in (("captured", cap), ("host", host)):
        row[f"{name}_wall"] = statistics.median(
            timed_runs(torch, run, runs)) / steps
        row[f"{name}_decode"] = statistics.median(
            timed_runs(torch, decode[name], runs)) / G
        busy, span, seen[name], tries[name], _ = witnessed(
            torch, ops, f"{tag} {name}", run)
        row[f"{name}_busy"], row[f"{name}_span"] = busy / steps, span / steps
    log(f"[graph] {tag} B={tokens.shape[0]}: the profiled generates' launch "
        f"counts equal the profiler's kernels by symbol: captured "
        f"{seen['captured']}, host loop {seen['host']} (profiled runs "
        f"taken: {tries})")
    log(f"[graph] {tag} B={tokens.shape[0]}: tokens and state bitwise the "
        f"host loop; per step (of {steps}, prefill included): wall captured "
        f"{row['captured_wall'] * 1e3:.4f} ms / host loop "
        f"{row['host_wall'] * 1e3:.4f} ms, device busy captured "
        f"{row['captured_busy'] * 1e3:.4f} ms (span "
        f"{row['captured_span'] * 1e3:.4f}) / host loop "
        f"{row['host_busy'] * 1e3:.4f} ms; busy share captured "
        f"{row['captured_busy'] / row['captured_wall']:.1%} / host loop "
        f"{row['host_busy'] / row['host_wall']:.1%}; the decode loop "
        f"alone, wall / step (of {G}): captured "
        f"{row['captured_decode'] * 1e3:.4f} ms / host loop "
        f"{row['host_decode'] * 1e3:.4f} ms")
    GRAPH_ROWS.append(row)
    return row


def zero_launches(ops) -> None:
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0


def run_path(torch, ops, tag, eng, packed, tokens, expect, runs=RUNS):
    """One warm generate (it captures the decode graph), then one with
    every launch count set to 0 just before it and read just after (held
    against ``expect``: kernel → count, 0 for the rest: the prefill's
    launches and the graph's replayed ones), then ``runs`` timed generates
    and the host-loop comparison. Returns (tokens, state, launch counts of
    the path's kernels)."""
    B, P, G = SERVE["batch"], SERVE["prompt"], SERVE["gen"]
    expect = {k: expect.get(k, 0) for k in ops.LAUNCHES}
    eng.generate(packed, tokens, G)
    zero_launches(ops)
    out, state = eng.generate(packed, tokens, G, return_state=True)
    torch.cuda.synchronize()
    got = dict(ops.LAUNCHES)
    log(f"[serve] {tag}: launches {({k: n for k, n in got.items() if n})} "
        f"(expected {({k: n for k, n in expect.items() if n})}: (prompt + "
        f"gen) x layers per kernel of the path)")
    if got != expect:
        raise AssertionError(f"{tag} path launched {got}, expected {expect}")
    vocab = eng.model.cfg.vocab_size
    if out.shape != (B, G) or not bool(((out >= 0) & (out < vocab)).all()):
        raise AssertionError(f"bad tokens: shape {tuple(out.shape)}")
    if runs:
        dts = timed_runs(torch, lambda: eng.generate(packed, tokens, G),
                         runs)
        med = statistics.median(dts)
        log(f"[serve] {tag} greedy B={B} prompt={P} gen={G}: median "
            f"{med:.4f}s of {runs} runs ({B * G / med:.1f} tok/s, prefill "
            f"included; range {min(dts):.4f}-{max(dts):.4f}s, "
            f"{B * G / max(dts):.1f}-{B * G / min(dts):.1f} tok/s)")
    versus_host_loop(torch, tag, eng, packed, tokens, out, state,
                     runs=3 if runs > 1 else 1)
    return out, state, {k: n for k, n in got.items() if n}


def replay_check(torch, ops, eng, packed, tokens):
    """One replay of the float chained decode graph under the profiler:
    the launch counts it adds equal the kernels the profiler saw by name
    (B1 ``rb_dual_staged_kernel``, B2 ``lstm_gates_kernel``), and how many
    B2 launches started before their B1 ended (the programmatic edge kept
    in the graph lets B2's blocks start early)."""
    from repro_torch.serving import SamplingConfig, runtime
    G = SERVE["gen"]
    logits, cache = eng.model.prefill(packed, tokens, eng.max_len)
    torch.cuda.synchronize()
    _, _, seen, n, ev = witnessed(
        torch, ops, "one replay", lambda: runtime.decode_loop(
            eng.model, packed, cache, logits, tokens.shape[1], None, G,
            SamplingConfig(), limit=eng.max_len, graphs=eng.graphs))
    order = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in ev if "rb_dual_staged_kernel" in e.name
                   or "lstm_gates_kernel" in e.name)
    early = sum(1 for a, b in zip(order, order[1:])
                if "rb_dual" in a[2] and "lstm_gates" in b[2] and b[0] < a[1])
    log(f"[graph] one replay of the float chained decode graph: launch "
        f"counts equal the profiler's kernels by name, {seen} (profiled "
        f"runs taken: {n}); B2 started before its B1 ended in {early} of "
        f"{seen['lstm_gates']} steps")
    if seen != {"rb_dual_spmv": G, "lstm_gates": G}:
        raise AssertionError(f"one replay launched {seen}")
    graph_pair(torch, eng, packed, tokens)
    return early


def graph_pair(torch, eng, packed, tokens, n=64, reps=10):
    """The chained float step's pair, B1 then B2, ``n`` times in one CUDA
    graph, B2 launched as B1's programmatic dependent in one graph and
    plainly in the other: their replays timed alternately (CUDA events,
    median of ``reps``), and the two graphs' c and h bitwise equal. The
    difference a pair says whether the programmatic edge survived the
    capture (outside a graph it shortens a pair by ~2.5 us, PERF.md §6)."""
    import importlib
    from repro_torch.kernels import ops
    from repro_torch.models.layers import embed_apply
    kg = importlib.import_module("repro_torch.kernels.lstm_gates")
    lp = packed["layers"][0]
    x = embed_apply(packed["embed"], tokens[:, 0]).contiguous()
    H = eng.model.cfg.hidden
    h = torch.zeros((tokens.shape[0], H), device=x.device)
    c = torch.zeros_like(h)
    out = {}

    def body(pdl):
        for _ in range(n):
            z = ops.rb_dual_spmv(lp["w_x"], x, lp["w_h"], h, lp["b"])
            out[pdl] = kg.lstm_gates(z[:, :H], z[:, H:2 * H],
                                     z[:, 2 * H:3 * H], z[:, 3 * H:], c,
                                     pdl=pdl)

    graphs = {}
    for pdl in (True, False):
        body(pdl)
        torch.cuda.synchronize()
        graphs[pdl] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[pdl]):
            body(pdl)
    times = {True: [], False: []}
    for _ in range(reps):
        for pdl in (True, False):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda._sleep(2_000_000)
            s.record()
            graphs[pdl].replay()
            e.record()
            torch.cuda.synchronize()
            times[pdl].append(s.elapsed_time(e) / n)
    same = all(torch.equal(a, b) for a, b in zip(out[True], out[False]))
    t = {k: statistics.median(v) for k, v in times.items()}
    log(f"[graph] {n} pairs B1 -> B2 in one graph: {t[True]:.4f} ms a pair "
        f"with B2 a programmatic dependent, {t[False]:.4f} ms plain "
        f"({(t[True] - t[False]) * 1e3:+.2f} us; median of {reps} replays "
        f"each, alternated); c and h bitwise equal: {same}")
    if not same:
        raise AssertionError("the PDL and plain graphs differ")


def check_plain(torch, tag, eng, packed, tokens, out):
    """The same run on the plain versions: teacher-forced logits within
    LOGIT_TOL, greedy tokens identical up to the first step whose top-2
    margin is below MARGIN. Returns that step."""
    from repro_torch.sparse import use_backend
    P, G = SERVE["prompt"], SERVE["gen"]
    with use_backend("ref"):
        out_ref = eng.generate(packed, tokens, G)
    seq = torch.cat([tokens, out.to(tokens.dtype)], 1)
    lg_k = teacher_forced(torch, eng.model, packed, seq)
    with use_backend("ref"):
        lg_r = teacher_forced(torch, eng.model, packed, seq)
    if not bool(torch.isfinite(lg_k).all()):
        raise AssertionError(f"{tag}: non-finite logits on the kernel path")
    dl = (lg_k - lg_r).abs().max().item()
    if not dl <= LOGIT_TOL:
        raise AssertionError(f"{tag}: logits differ by {dl:.3e}")
    first = first_small_margin(lg_r)
    margin = margins(lg_r)
    same = bool(torch.equal(out[:, :first], out_ref[:, :first]))
    log(f"[serve] {tag}: teacher-forced logits, kernels vs plain: max|diff| "
        f"{dl:.3e} (tol {LOGIT_TOL:.0e}); greedy tokens identical up to "
        f"step {first} (first step with a top-2 margin < {MARGIN:.0e}: "
        f"{'none' if first == G else first}; smallest margin "
        f"{margin.min().item():.3e}); full match "
        f"{bool(torch.equal(out, out_ref))}")
    if not same:
        raise AssertionError(f"{tag}: greedy tokens differ before any small "
                             "margin")
    return first


def margins(logits):
    """Per-step smallest top-2 margin over the batch, generated steps."""
    top2 = logits[:, SERVE["prompt"] - 1:].topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]).amin(dim=0)


def first_small_margin(logits) -> int:
    low = (margins(logits) < MARGIN).nonzero()
    return int(low[0]) if len(low) else SERVE["gen"]


def same_tokens(torch, what, a, b, upto=None):
    n = a.shape[1] if upto is None else upto
    if not torch.equal(a[:, :n], b[:, :n]):
        raise AssertionError(f"{what}: tokens differ (compared steps < {n})")
    log(f"[serve] {what}: tokens identical"
        + ("" if upto is None else f" up to step {n}"))


def serve(torch, device):
    """Phase 3: full-width lstm_ptb greedy serving on every path: packed
    float, temporal delta and quantized, fused and chained, each against
    the plain versions. Returns each kernel's launch count from the path
    that runs it."""
    from repro_torch.kernels import ops
    from repro_torch.models import LSTMModel, LSTM_CONFIGS
    from repro_torch.serving import ServeEngine
    from repro_torch.sparse import (DeltaGateConfig, QuantConfig,
                                    lstm_policy, occupancy_report)
    cfg = LSTM_CONFIGS["lstm_ptb"]
    B, P, G = SERVE["batch"], SERVE["prompt"], SERVE["gen"]
    params = LSTMModel(cfg).init(torch.Generator().manual_seed(0), device)
    tokens = torch.randint(0, cfg.vocab_size, (B, P),
                           generator=torch.Generator().manual_seed(1)
                           ).to(device)
    # a prompt-shaped calibration batch, as launch.serve draws it
    calib = torch.randint(0, cfg.vocab_size, (B, min(P, 32)),
                          generator=torch.Generator().manual_seed(3)
                          ).to(device)
    want = (P + G) * cfg.num_layers

    def prepared(tag, fused=True, **rules):
        eng = ServeEngine(LSTMModel(cfg, fused=fused), max_len=P + G,
                          sparsity=lstm_policy(0.75, 0.5, **rules),
                          device=device)
        t0 = time.perf_counter()
        packed, report = eng.prepare(
            params, calib=calib if "quant" in rules else None)
        torch.cuda.synchronize()
        lp = packed["layers"][0]
        log(f"[serve] {tag}: lstm_ptb X={cfg.input_size} H={cfg.hidden} "
            f"V={cfg.vocab_size} layers={cfg.num_layers}; prepare "
            f"{time.perf_counter() - t0:.2f}s: W_x "
            f"{tuple(lp['w_x'].values.shape)} {lp['w_x'].values.dtype}/"
            f"{lp['w_x'].deltas.dtype}, W_h {tuple(lp['w_h'].values.shape)} "
            f"{lp['w_h'].values.dtype}/{lp['w_h'].deltas.dtype}, packed/dense "
            f"bytes {report['ratio']:.4f}"
            + (f", act scales {eng.model.quant.act_scales}"
               if eng.model.quant else ""))
        return eng, packed

    def chained(eng):
        return ServeEngine(eng.model.with_fused(False), max_len=P + G,
                           device=device)

    launches = {}
    # packed float: fused (the default) and chained
    eng, packed = prepared("float")
    out, _, n = run_path(torch, ops, "float fused", eng, packed, tokens,
                         {"fused_brds_lstm_step": want})
    launches.update(n)
    ceng = chained(eng)
    out_c, _, n = run_path(torch, ops, "float chained", ceng, packed,
                           tokens, {"rb_dual_spmv": want, "lstm_gates": want})
    launches.update(n)
    replay_check(torch, ops, ceng, packed, tokens)
    same_tokens(torch, "float fused vs chained", out, out_c)
    float_first = check_plain(torch, "float", eng, packed, tokens, out)
    float_out = out
    # B=32: the step kernel runs two 16-row tiles a launch; rows 0-7 take
    # the B=8 prompts, so their tokens are the B=8 tokens (up to the first
    # small top-2 margin: the head's dense matmul may sum in another order
    # at another batch)
    wide = torch.cat([tokens, torch.randint(
        0, cfg.vocab_size, (32 - B, P),
        generator=torch.Generator().manual_seed(5)).to(device)])
    eng.generate(packed, wide, G)               # captures the B=32 graph
    zero_launches(ops)
    out32, st32 = eng.generate(packed, wide, G, return_state=True)
    torch.cuda.synchronize()
    got = {k: n for k, n in ops.LAUNCHES.items() if n}
    log(f"[serve] float fused B=32: launches {got}")
    if got != {"fused_brds_lstm_step": want} or out32.shape != (32, G):
        raise AssertionError(f"B=32 serve launched {got}, tokens "
                             f"{tuple(out32.shape)}")
    same_tokens(torch, "float fused B=32, rows 0-7, vs B=8", out32[:B],
                float_out, upto=float_first)
    versus_host_loop(torch, "float fused", eng, packed, wide, out32, st32)

    # temporal delta at Θ = 0: fused and chained; then Θ = 0.05
    eng, packed = prepared("delta0", delta=DeltaGateConfig())
    out, state, n = run_path(torch, ops, "delta0 fused", eng, packed, tokens,
                             {"fused_brds_delta_lstm_step": want})
    launches.update(n)
    out_c, _, n = run_path(torch, ops, "delta0 chained", chained(eng),
                           packed, tokens, {"delta_rb_dual_spmv": want,
                                            "lstm_gates": want})
    launches.update(n)
    same_tokens(torch, "delta0 fused vs chained", out, out_c)
    check_plain(torch, "delta0", eng, packed, tokens, out)
    same_tokens(torch, "delta0 vs packed float (Θ = 0 is exact up to "
                "re-association)", out, float_out, upto=float_first)
    occ = occupancy_report(state["cache"], steps=P + G, packed=packed)
    log(f"[serve] delta0 occupancy x={occ['occupancy_x']:.4f} "
        f"h={occ['occupancy_h']:.4f}")
    eng, packed = prepared("delta0.05",
                           delta=DeltaGateConfig(theta_x=0.05, theta_h=0.05))
    out, state, _ = run_path(torch, ops, "delta0.05 fused", eng, packed,
                             tokens, {"fused_brds_delta_lstm_step": want})
    check_plain(torch, "delta0.05", eng, packed, tokens, out)
    occ = occupancy_report(state["cache"], steps=P + G, packed=packed)
    log(f"[serve] delta0.05 occupancy x={occ['occupancy_x']:.4f} "
        f"h={occ['occupancy_h']:.4f}, effective-ops reduction "
        f"{occ['ops_reduction']:.3f}x (tokens not gated against float)")

    # quantized: int8 fused and chained, q1.11 fused
    eng, packed = prepared("int8", quant=QuantConfig("int8"))
    out, _, n = run_path(torch, ops, "int8 fused", eng, packed, tokens,
                         {"fused_brds_lstm_step_q8": want})
    launches.update(n)
    out_c, _, n = run_path(torch, ops, "int8 chained", chained(eng), packed,
                           tokens, {"rb_dual_parts_q8": want,
                                    "lstm_gates": want})
    launches.update(n)
    same_tokens(torch, "int8 fused vs chained", out, out_c)
    check_plain(torch, "int8", eng, packed, tokens, out)
    eng, packed = prepared("q1.11", quant=QuantConfig("q1.11"))
    out, _, _ = run_path(torch, ops, "q1.11 fused", eng, packed, tokens,
                         {"fused_brds_lstm_step_q8": want})
    check_plain(torch, "q1.11", eng, packed, tokens, out)

    # Θ = 0 delta with int8: fused and chained
    eng, packed = prepared("delta0+int8", delta=DeltaGateConfig(),
                           quant=QuantConfig("int8"))
    out, _, n = run_path(torch, ops, "delta0+int8 fused", eng, packed,
                         tokens, {"fused_brds_delta_lstm_step_q8": want})
    launches.update(n)
    out_c, _, _ = run_path(torch, ops, "delta0+int8 chained", chained(eng),
                           packed, tokens, {"rb_dual_parts_q8": want,
                                            "lstm_gates": want}, runs=1)
    same_tokens(torch, "delta0+int8 fused vs chained", out, out_c)
    check_plain(torch, "delta0+int8", eng, packed, tokens, out)
    return launches, float_first


def spec_serve(torch, device, first):
    """Phase 4: speculative greedy decode of the packed full-width lstm_ptb
    target with three drafts, each with every launch count set to 0 just
    before one generate and read just after: the tokens must be the
    target-only greedy tokens up to ``first`` (the float path's first
    small-margin step), the packed float drafts must prime their prompt
    state through one scan launch per layer, and the kernel counts must be
    what the rounds imply. Then the delta scan op over the prompt on a Θ=0
    delta layer, bitwise the model's own prefill state. Returns the scans'
    launch counts."""
    import dataclasses
    from repro_torch.kernels import ops
    from repro_torch.models import LSTMModel, LSTM_CONFIGS
    from repro_torch.models.layers import embed_apply
    from repro_torch.serving import ServeEngine
    from repro_torch.sparse import DeltaGateConfig, lstm_policy
    from repro_torch.spec import DraftModel
    cfg = LSTM_CONFIGS["lstm_ptb"]
    B, P, G, K = SERVE["batch"], SERVE["prompt"], SERVE["gen"], SPEC_K
    params = LSTMModel(cfg).init(torch.Generator().manual_seed(0), device)
    tokens = torch.randint(0, cfg.vocab_size, (B, P),
                           generator=torch.Generator().manual_seed(1)
                           ).to(device)

    def engine(c, **rules):
        return ServeEngine(LSTMModel(c), max_len=P + G, device=device,
                           sparsity=lstm_policy(0.75, 0.5, **rules))

    eng = engine(cfg)
    packed, _ = eng.prepare(params)
    base = eng.generate(packed, tokens, G)
    dts = timed_runs(torch, lambda: eng.generate(packed, tokens, G))
    med = statistics.median(dts)
    log(f"[spec] target-only greedy: median {med:.4f}s ({B * G / med:.1f} "
        f"tok/s; range {B * G / max(dts):.1f}-{B * G / min(dts):.1f})")
    # lstm_imdb at its published width as a language model over the
    # target's vocabulary (its classifier head becomes a vocabulary head)
    imdb = dataclasses.replace(LSTM_CONFIGS["lstm_imdb"],
                               vocab_size=cfg.vocab_size, num_classes=0)
    ieng = engine(imdb)
    iparams, _ = ieng.prepare(ieng.model.init(
        torch.Generator().manual_seed(7), device))
    deng = engine(cfg, delta=DeltaGateConfig())
    dpacked, _ = deng.prepare(params)
    drafts = {"self": (DraftModel(eng.model, packed), "fused_brds_lstm_step",
                       cfg.num_layers),
              "lstm_imdb": (DraftModel(ieng.model, iparams),
                            "fused_brds_lstm_step", imdb.num_layers),
              "delta0": (DraftModel(deng.model, dpacked),
                         "fused_brds_delta_lstm_step", 0)}
    launches = {}
    for tag, (draft, step, scans) in drafts.items():
        # the first call captures the chunk of rounds
        eng.generate(packed, tokens, G, draft=draft, spec_k=K)
        zero_launches(ops)
        out, st = eng.generate(packed, tokens, G, draft=draft, spec_k=K,
                               return_state=True)
        torch.cuda.synchronize()
        got = {k: n for k, n in ops.LAUNCHES.items() if n}
        rounds = int(st["rounds"].max())
        # the captured chunks run eng.spec_rounds rounds each, the rounds
        # after every row is done changing nothing (one host read a chunk)
        ran = st["chunks"] * eng.spec_rounds
        dl = draft.model.cfg.num_layers
        # target: prompt steps, then k+1 verify steps a round; draft: its
        # prompt (one scan a layer, or P steps) and k+1 proposal steps
        want = {"fused_brds_lstm_step": (P + (K + 1) * ran)
                * cfg.num_layers}
        want[step] = want.get(step, 0) + (K + 1) * ran * dl
        if scans:
            want["fused_brds_lstm_scan"] = scans
        else:
            want[step] += P * dl
        log(f"[spec] {tag} draft: launches {got} (expected {want}: "
            f"{st['chunks']} chunks of {eng.spec_rounds} rounds, {rounds} "
            f"of them active, of {K + 1} verify and {K + 1} draft steps, "
            "prefills)")
        if got != want:
            raise AssertionError(f"spec {tag}: launched {got}, expected "
                                 f"{want}")
        if scans:
            launches.setdefault("fused_brds_lstm_scan", got[
                "fused_brds_lstm_scan"])
        same_tokens(torch, f"spec {tag} vs target-only greedy", out, base,
                    upto=first)
        acc, drafted = int(st["accepted"].sum()), int(st["drafted"].sum())
        dts = timed_runs(torch, lambda: eng.generate(
            packed, tokens, G, draft=draft, spec_k=K))
        med = statistics.median(dts)
        log(f"[spec] {tag} draft, spec_k={K}: full match "
            f"{bool(torch.equal(out, base))}; acceptance "
            f"{acc / max(drafted, 1):.4f} ({acc}/{drafted}), {rounds} rounds "
            f"(per-row {st['rounds'].tolist()}); median {med:.4f}s of "
            f"{RUNS} runs ({B * G / med:.1f} tok/s; range "
            f"{B * G / max(dts):.1f}-{B * G / min(dts):.1f}), "
            f"{med / rounds * 1e3:.3f} ms per round")

    # the delta scan op: a Θ=0 layer's state over the prompt in one launch
    lp = dpacked["layers"][0]
    xs = embed_apply(dpacked["embed"], tokens).transpose(0, 1).contiguous()
    H, X = cfg.hidden, cfg.input_size
    z = lambda n: torch.zeros((B, n), device=device)
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    got = ops.fused_brds_delta_lstm_scan(
        lp["w_x"], xs, lp["w_h"], z(H), z(H), z(X), z(H), z(4 * H), lp["b"],
        theta_x=0.0, theta_h=0.0, pwl=cfg.pwl_activations)
    torch.cuda.synchronize()
    n = ops.LAUNCHES["fused_brds_delta_lstm_scan"]
    log(f"[spec] delta scan op over the prompt: launches "
        f"{ {k: v for k, v in ops.LAUNCHES.items() if v} }")
    if n != 1 or sum(ops.LAUNCHES.values()) != 1:
        raise AssertionError(f"delta scan op launched {ops.LAUNCHES}")
    launches["fused_brds_delta_lstm_scan"] = n
    _, cache = deng.model.prefill(dpacked, tokens, P + G)
    lc = cache["layers"][0]
    want = (lc["h"], lc["c"], lc["x_ref"], lc["h_ref"], lc["m"])
    if not all(torch.equal(g, w) for g, w in zip((got[0][-1], *got[1:]),
                                                 want)):
        raise AssertionError("delta scan state differs from the delta "
                             "model's prefill state")
    log("[spec] delta scan op: h, c, x_ref, h_ref, m bitwise the Θ=0 "
        "model's prefill state")
    return launches


def format_api(torch, device):
    """Phase 4: the sparse-format API on lstm_ptb's W_x and W_h (seed 0) at
    lstm_policy(0.75, 0.5), B=8, with every launch count set to 0 just
    before and read just after; the single-family kernels must have
    launched. Returns their launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.models import LSTMModel, LSTM_CONFIGS
    from repro_torch.sparse import formats, get_format, lstm_policy
    cfg = LSTM_CONFIGS["lstm_ptb"]
    B = SERVE["batch"]
    params = LSTMModel(cfg).init(torch.Generator().manual_seed(0), device)
    lp = params["layers"][0]
    plan = lstm_policy(0.75, 0.5).compile(params)
    g = torch.Generator(device=device).manual_seed(4)
    rand = lambda *shape: torch.randn(*shape, generator=g, device=device)
    x, h = rand(B, cfg.input_size), rand(B, cfg.hidden)
    bias = 0.1 * rand(4 * cfg.hidden)

    def close(what, a, b, tol):
        e = (a.float().cpu() - b.float().cpu()).abs().max().item()
        if not e <= tol:
            raise AssertionError(f"{what}: max |card - plain| = {e:.3e} > "
                                 f"{tol:.0e}")
        log(f"[format] {what}: max|diff| {e:.3e} (tol {tol:.0e})")

    def equal(what, a, b):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: not equal")
        log(f"[format] {what}: exactly equal")

    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    pruned, masks = plan.prune(params)
    packed, _ = plan.pack(pruned, masks)
    px, ph = packed["layers"][0]["w_x"], packed["layers"][0]["w_h"]
    for path, p, v in (("layers/0/w_x", px, x), ("layers/0/w_h", ph, h)):
        close(f"plan.matvec({path!r})", plan.matvec(path, p, v),
              plan.matvec(path, p, v, backend="ref"), Z_TOL)
    rb = get_format("row_balanced")
    close("row_balanced.dual_matvec", rb.dual_matvec(px, x, ph, h, bias),
          rb.dual_matvec(px, x, ph, h, bias, backend="ref"), Z_TOL)
    q8 = get_format("row_balanced_q8")
    for spec in SCHEMES:
        qx = q8.pack(lp["w_x"], masks["layers/0/w_x"], scheme=spec)
        qh = q8.pack(lp["w_h"], masks["layers/0/w_h"], scheme=spec)
        equal(f"row_balanced_q8.matvec {spec}", q8.matvec(qx, x),
              q8.matvec(qx, x, backend="ref"))
        equal(f"row_balanced_q8.dual_matvec {spec}",
              q8.dual_matvec(qx, x, qh, h, bias),
              q8.dual_matvec(qx, x, qh, h, bias, backend="ref"))
    d = 0.5 * rand(B, cfg.input_size)
    for share in (0.5, 1.0):
        fired = torch.rand(B, cfg.input_size, generator=g,
                           device=device) < share
        close(f"ops.delta_rb_spmv fired {float(fired.float().mean()):.2f}",
              ops.delta_rb_spmv(px, d, fired),
              ops.delta_rb_spmv(px, d, fired, backend="ref"), Z_TOL)
    torch.cuda.synchronize()
    got = {k: ops.LAUNCHES[k] for k in FORMAT_KERNELS}
    log(f"[format] launches {got}")
    if not all(got.values()):
        raise AssertionError(f"format API launched {got}: a kernel of the "
                             "path never ran")

    # the baseline formats at ratio 0.75 on W_x, mask on the card vs the
    # CPU; bank-balanced W_h for the mixed pair
    wx, wh = lp["w_x"], lp["w_h"]
    opts = {"bank_balanced": {"num_banks": 4}, "block": {"block": (4, 4)},
            "unstructured": {}}
    for name, o in opts.items():
        fmt = get_format(name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m_card = fmt.mask(wx, 0.75, **o)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        t0 = time.perf_counter()
        m_cpu = fmt.mask(wx.cpu(), 0.75, **o)
        dt_cpu = time.perf_counter() - t0
        equal(f"{name} mask on the card vs the CPU ({dt * 1e3:.1f} ms on "
              f"the card, {dt_cpu * 1e3:.1f} ms on the CPU)", m_card.cpu(),
              m_cpu)
        p_card, p_cpu = fmt.pack(wx, m_card, **o), fmt.pack(wx.cpu(), m_cpu,
                                                             **o)
        mem = fmt.memory_bytes(p_card, **o)
        if mem != fmt.memory_bytes(p_cpu, **o):
            raise AssertionError(f"{name}: memory_bytes differ")
        log(f"[format] {name}: memory_bytes equal, total {mem['total']} "
            f"(ratio {mem['ratio']:.4f})")
        close(f"{name}.matvec on the card vs the CPU", fmt.matvec(p_card, x),
              fmt.matvec(p_cpu, x.cpu()), Z_TOL)
    bank = get_format("bank_balanced")
    pb = bank.pack(wh, bank.mask(wh, 0.5, num_banks=4))
    pb_cpu = bank.pack(wh.cpu(), bank.mask(wh.cpu(), 0.5, num_banks=4))
    close("formats.dual_matvec(row_balanced, bank_balanced) on the card vs "
          "the CPU",
          formats.dual_matvec(rb, px, x, bank, pb, h, bias),
          formats.dual_matvec(rb, px.to("cpu"), x.cpu(), bank, pb_cpu,
                              h.cpu(), bias.cpu()), Z_TOL)
    return got


def attn_case(torch, device, dtype, *, B, Hq, Hkv, Sq, Sk, D, seed):
    """q, k, v in the model's (B, S, H, D) layout from one seeded generator
    on the card, handed over as (B, H, S, D) views, as the model does."""
    g = torch.Generator(device=device).manual_seed(seed)
    rand = lambda *shape: torch.randn(*shape, generator=g,
                                      device=device).to(dtype)
    q = rand(B, Sq, Hq, D).transpose(1, 2)
    k = rand(B, Sk, Hkv, D).transpose(1, 2)
    v = rand(B, Sk, Hkv, D).transpose(1, 2)
    return q, k, v


def attn_held(torch, name, got, want, tag, mag=None, n_keys=0) -> float:
    """An attention kernel's output held to its plain version's: float32
    within ATTN_TOL, bf16 within one ulp (BF16_ULP relative) of each
    output plus a floor for outputs near 0, where both round float32 sums
    of up to ``n_keys`` terms taken in another order: 1e-6, or where
    ``mag`` (each output's sum of |p v|, the plain version over |v|) is
    given, the larger of 1e-6 and the float32 eps times mag times
    sqrt(n_keys), that sum's own rounding. Returns the largest
    |kernel - plain|."""
    torch.cuda.synchronize()
    d = (got.float() - want.float()).abs()
    e = d.max().item()
    if got.dtype == torch.float32:
        ok, tol = e <= ATTN_TOL, f"{ATTN_TOL:.0e}"
    else:
        ulp = BF16_ULP * want.float().abs()
        floor, say = 1e-6, "1e-6"
        if mag is not None:
            floor = (torch.finfo(torch.float32).eps * math.sqrt(n_keys)
                     * mag.float()).clamp(min=1e-6)
            say = (f"max(1e-6, eps32 |p v| sqrt({n_keys})) <= "
                   f"{floor.max().item():.2e}")
        ok = bool((d <= ulp + floor).all())
        tol = (f"one bf16 ulp + {say}; past one ulp: "
               f"{int((d > ulp).sum())} of {d.numel()}")
    if not ok:
        raise AssertionError(f"{name} {tag}: max |kernel - plain| = "
                             f"{e:.3e} > {tol}")
    log(f"  {name:16} {tag}: max|err| {e:.3e} (tol {tol})")
    return e


def check_attention(torch, device, flush):
    """Phase 2b: B14 and B15 against their plain versions at four shapes
    each, float32 (ATTN_TOL) and bf16 (one ulp, BF16_ULP relative): the
    qwen3-0.6b serve shape; an odd one (D=64, MQA, a window, ragged
    lengths with 0, 1 and S); a long one (B14 at S=32768, B15 at Sk=4096
    with Sq < Sk); head_dim 192 (ragged, B15 with Sq < Sk). Then each
    kernel timed at the serve shape in bf16 with
    L2 flushed, beside its plain version, its bound and
    ``scaled_dot_product_attention`` (``enable_gqa=True``, a yardstick the
    port never calls). Returns the two kernels' records."""
    from repro_torch.kernels import ops
    from repro_torch.kernels._build import time_ms
    F = torch.nn.functional
    rec = {n: dict(max_abs_err=0.0) for n in ATTN_KERNELS}
    B, P, G = TSERVE["batch"], TSERVE["prompt"], TSERVE["gen"]
    S = TSERVE["max_len"]

    def held(name, got, want, tag, serve):
        e = attn_held(torch, name, got, want, tag)
        if serve and got.dtype == torch.bfloat16:
            rec[name]["max_abs_err"] = e

    dec = [("serve", dict(B=B, Hq=16, Hkv=8, S=S, D=128), None,
            [P + G // 2] * B),
           ("odd", dict(B=5, Hq=8, Hkv=1, S=700, D=64), 100,
            [0, 1, 700, 333, 64]),
           ("long", dict(B=2, Hq=16, Hkv=8, S=32768, D=128), None,
            [32768, 20001]),
           ("d192", dict(B=3, Hq=8, Hkv=2, S=600, D=192), None,
            [0, 1, 600])]
    for dtype in (torch.float32, torch.bfloat16):
        for tag, sh, win, lens in dec:
            q, k, v = attn_case(torch, device, dtype, B=sh["B"], Hq=sh["Hq"],
                                Hkv=sh["Hkv"], Sq=1, Sk=sh["S"], D=sh["D"],
                                seed=sh["S"])
            q = q[:, :, 0]
            n = torch.tensor(lens, dtype=torch.int32, device=device)
            held("decode_attention",
                 ops.decode_attention(q, k, v, n, window=win, backend="cuda"),
                 ops.decode_attention(q, k, v, n, window=win, backend="ref"),
                 f"{tag} {sh} window={win} lengths={lens} {dtype}",
                 tag == "serve")
    fla = [("serve", dict(B=B, Hq=16, Hkv=8, Sq=P, Sk=P, D=128), None),
           ("odd", dict(B=3, Hq=8, Hkv=1, Sq=300, Sk=300, D=64), 100),
           ("long", dict(B=1, Hq=16, Hkv=8, Sq=1024, Sk=4096, D=128), None),
           ("d192", dict(B=2, Hq=8, Hkv=4, Sq=200, Sk=333, D=192), None)]
    for dtype in (torch.float32, torch.bfloat16):
        for tag, sh, win in fla:
            q, k, v = attn_case(torch, device, dtype, **sh, seed=sh["Sk"])
            held("flash_attention",
                 ops.flash_attention(q, k, v, window=win, backend="cuda"),
                 ops.flash_attention(q, k, v, window=win, backend="ref"),
                 f"{tag} {sh} window={win} {dtype}", tag == "serve")

    # times at the serve shapes, bf16: decode at the run's mean length
    bf = torch.bfloat16
    q, k, v = attn_case(torch, device, bf, B=B, Hq=16, Hkv=8, Sq=1, Sk=S,
                        D=128, seed=1)
    q = q[:, :, 0]
    L = P + G // 2
    n = torch.full((B,), L, dtype=torch.int32, device=device)
    decode_one_launch(torch, ops, q, k, v, n)
    mask = (torch.arange(S, device=device) < L)[None, None, None, :]
    live = B * 8 * L * 128 * 2              # K and V rows up to the length
    # operations, at the bf16 tensor-core rate: the function's own,
    # ATTN_FLOPS per live (q, k) pair and head dim (B14's second P·V term
    # and B15's three, p split exactly into bf16 terms, are costs of the
    # kernels' design, not of the work)
    dec_run = (
        lambda: ops.decode_attention(q, k, v, n, backend="cuda"),
        lambda: ops.decode_attention(q, k, v, n, backend="ref"),
        lambda: F.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=mask, enable_gqa=True),
        bound(nbytes(q) * 2 + live * 2, 0,
              bf16_flops=ATTN_FLOPS * B * 16 * L * 128))
    qf, kf, vf = attn_case(torch, device, bf, B=B, Hq=16, Hkv=8, Sq=P, Sk=P,
                           D=128, seed=2)
    pairs = B * 16 * P * (P + 1) // 2       # live (q, k) pairs, causal
    fla_run = (
        lambda: ops.flash_attention(qf, kf, vf, backend="cuda"),
        lambda: ops.flash_attention(qf, kf, vf, backend="ref"),
        lambda: F.scaled_dot_product_attention(qf, kf, vf, is_causal=True,
                                               enable_gqa=True),
        bound(nbytes(qf, kf, vf, qf), 0, bf16_flops=ATTN_FLOPS * 128 * pairs))
    diff = (dec_run[2]()[:, :, 0].float() - dec_run[1]().float()).abs()
    log(f"  scaled_dot_product_attention (B14's yardstick) vs plain: "
        f"max|diff| {diff.max().item():.3e}")
    for name, (kern, plain, lib, (bms, by)) in zip(ATTN_KERNELS,
                                                   (dec_run, fla_run)):
        r = rec[name]
        r["ms"] = time_ms(kern, flush)
        r["plain_ms"] = time_ms(plain, flush)
        r["library_ms"] = time_ms(lib, flush)
        r["bound_ms"], r["bound_by"] = bms, by
        log(f"[time] {name:29} kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"bound {bms * 1e3:.2f} us ({by}; operations at the bf16 "
            f"tensor-core rate) — median of 30, L2 flushed, bf16, serve "
            f"shape")
    # decode at the long shape (phase 6's: B=2, S=32768, lengths 32768 and
    # 20001), beside its plain version and its bound
    q, k, v = attn_case(torch, device, bf, B=2, Hq=16, Hkv=8, Sq=1, Sk=32768,
                        D=128, seed=3)
    q = q[:, :, 0]
    lens = [32768, 20001]
    n = torch.tensor(lens, dtype=torch.int32, device=device)
    live = 8 * sum(lens) * 128 * 2
    bms, by = bound(nbytes(q) * 2 + live * 2, 0,
                    bf16_flops=ATTN_FLOPS * 16 * sum(lens) * 128)
    log(f"[time] decode_attention long, lengths {lens}: kernel "
        f"{time_ms(lambda: ops.decode_attention(q, k, v, n, backend='cuda'), flush):.4f}"
        f" ms, plain {time_ms(lambda: ops.decode_attention(q, k, v, n, backend='ref'), flush):.4f}"
        f" ms, bound {bms * 1e3:.2f} us ({by}) — median of 30, L2 flushed, "
        "bf16")
    return rec


def check_attention_d256(torch, device, flush) -> None:
    """Phase 6 at recurrentgemma-9b's local attention: B15 at B=4, 16 q /
    1 kv heads of 256, causal, Sq = Sk = 2560, window 2048, and B14 over
    a 2624-row cache at lengths 2560 and ragged ones below and above 2048
    (0 and 1 among them), float32 (ATTN_TOL) and bf16 (one ulp) against
    their plain versions; then both timed in bf16 with L2 flushed beside
    the plain versions, ``scaled_dot_product_attention`` (``enable_gqa``,
    the window as a boolean mask) and the bound."""
    from repro_torch.kernels import ops
    from repro_torch.kernels._build import time_ms
    F = torch.nn.functional
    R = RSERVE["recurrentgemma-9b"]
    B, P, G, W = R["batch"], R["prompt"], R["gen"], R["window"]
    Hq, Hkv, D, S = R["heads"], R["kv_heads"], 256, P + G
    ragged = ([1, 2047, 2049, 2560], [0, 2048, 100, 2624])
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = attn_case(torch, device, dtype, B=B, Hq=Hq, Hkv=Hkv, Sq=P,
                            Sk=P, D=D, seed=4)
        attn_held(torch, "flash_attention",
                  ops.flash_attention(q, k, v, window=W, backend="cuda"),
                  ops.flash_attention(q, k, v, window=W, backend="ref"),
                  f"recurrentgemma-9b B={B} {Hq}/{Hkv}x{D} S={P} "
                  f"window={W} {dtype}")
        del q, k, v
        q, k, v = attn_case(torch, device, dtype, B=B, Hq=Hq, Hkv=Hkv, Sq=1,
                            Sk=S, D=D, seed=5)
        q = q[:, :, 0]
        for lens in ([P] * B, *ragged):
            n = torch.tensor(lens, dtype=torch.int32, device=device)
            attn_held(torch, "decode_attention",
                      ops.decode_attention(q, k, v, n, window=W,
                                           backend="cuda"),
                      ops.decode_attention(q, k, v, n, window=W,
                                           backend="ref"),
                      f"recurrentgemma-9b B={B} {Hq}/{Hkv}x{D} cache {S} "
                      f"lengths={lens} window={W} {dtype}")
        del q, k, v
    bf = torch.bfloat16
    q, k, v = attn_case(torch, device, bf, B=B, Hq=Hq, Hkv=Hkv, Sq=P, Sk=P,
                        D=D, seed=6)
    i = torch.arange(P, device=device)
    band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - W)
    pairs = B * Hq * int(band.sum())        # live (q, k) pairs
    fla = (lambda: ops.flash_attention(q, k, v, window=W, backend="cuda"),
           lambda: ops.flash_attention(q, k, v, window=W, backend="ref"),
           lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=band,
                                                  enable_gqa=True),
           bound(nbytes(q, k, v, q), 0, bf16_flops=ATTN_FLOPS * D * pairs))
    qd, kd, vd = attn_case(torch, device, bf, B=B, Hq=Hq, Hkv=Hkv, Sq=1,
                           Sk=S, D=D, seed=7)
    qd = qd[:, :, 0]
    n = torch.full((B,), P, dtype=torch.int32, device=device)
    kpos = torch.arange(S, device=device)
    live = (kpos < P) & (kpos > P - 1 - W)
    rows = int(live.sum())
    dec = (lambda: ops.decode_attention(qd, kd, vd, n, window=W,
                                        backend="cuda"),
           lambda: ops.decode_attention(qd, kd, vd, n, window=W,
                                        backend="ref"),
           lambda: F.scaled_dot_product_attention(
               qd[:, :, None], kd, vd, attn_mask=live[None, None, None],
               enable_gqa=True),
           bound(nbytes(qd) * 2 + B * Hkv * rows * D * 2 * 2, 0,
                 bf16_flops=ATTN_FLOPS * B * Hq * rows * D))
    for name, (kern, plain, lib, (bms, by)) in (("flash_attention", fla),
                                                ("decode_attention", dec)):
        ms, pms, lms = (time_ms(f, flush) for f in (kern, plain, lib))
        D256_TIMES[name] = dict(ms=ms, plain_ms=pms, library_ms=lms,
                                bound_ms=bms, bound_by=by)
        at = f"S={P}" if name == "flash_attention" else f"length {P}"
        log(f"[time] {name:29} recurrentgemma-9b (D=256, {Hq}/{Hkv} heads, "
            f"window {W}, {at}): kernel {ms:.4f} ms, plain "
            f"{pms:.4f} ms, library (SDPA) {lms:.4f} ms, bound "
            f"{bms * 1e3:.2f} us ({by}) — median of 30, L2 flushed, bf16")


def check_decode_lse(torch, device, flush) -> None:
    """Phase 6, B14's ``lse=`` output (the split-KV combine's weights), at
    qwen3-0.6b's decode shape (B=8, 16 / 8 heads of 128, 1024 rows) and
    the zoo's (``ZATTN["decode"]``), float32 and bf16, with ragged lengths
    that include 0: ``o`` bitwise the launch without ``lse``, ``lse``
    within LSE_ATOL of the plain version's, a row with no live key 0 and
    -inf; then the serve shape timed with and without it (L2 flushed)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels._build import time_ms
    shapes = [("qwen3-0.6b", dict(B=8, Hq=16, Hkv=8, S=TSERVE["max_len"],
                                  D=128, length=TSERVE["prompt"]))]
    shapes += [(t, sh) for t, sh in ZATTN["decode"]]
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for tag, sh in shapes:
            q, k, v = attn_case(torch, device, dtype, B=sh["B"], Hq=sh["Hq"],
                                Hkv=sh["Hkv"], Sq=1, Sk=sh["S"], D=sh["D"],
                                seed=sh["S"] + 7)
            q = q[:, :, 0]
            lens = [0] + [max(1, sh["length"] * (i + 1) // sh["B"])
                          for i in range(1, sh["B"])]
            n = torch.tensor(lens, dtype=torch.int32, device=device)
            lse = torch.empty(sh["B"], sh["Hq"], device=device)
            o = ops.decode_attention(q, k, v, n, lse=lse, backend="cuda")
            o0 = ops.decode_attention(q, k, v, n, backend="cuda")
            want = torch.empty_like(lse)
            ops.decode_attention(q, k, v, n, lse=want, backend="ref")
            torch.cuda.synchronize()
            if not torch.equal(o, o0):
                raise AssertionError(f"decode_attention {tag} {dtype}: o "
                                     "with lse differs from o without")
            dead = n == 0
            if not (torch.isneginf(lse[dead]).all()
                    and not o[dead].any()):
                raise AssertionError(f"decode_attention {tag}: a row with "
                                     "no live key is not 0 / -inf")
            e = (lse[~dead] - want[~dead]).abs().max().item()
            if not e <= LSE_ATOL or not torch.isfinite(lse[~dead]).all():
                raise AssertionError(f"decode_attention {tag} {dtype}: lse "
                                     f"{e:.3e} from the plain version's "
                                     f"(> {LSE_ATOL:.0e})")
            worst = max(worst, e)
            log(f"  decode_attention lse {tag} {sh} lengths {lens[:3]}... "
                f"{dtype}: o bitwise without lse; max |lse - plain| "
                f"{e:.3e} (tol {LSE_ATOL:.0e}); the length-0 row 0 / -inf")
    B, S, L = 8, TSERVE["max_len"], TSERVE["prompt"] + TSERVE["gen"] // 2
    q, k, v = attn_case(torch, device, torch.bfloat16, B=B, Hq=16, Hkv=8,
                        Sq=1, Sk=S, D=128, seed=1)
    q = q[:, :, 0]
    n = torch.full((B,), L, dtype=torch.int32, device=device)
    lse = torch.empty(B, 16, device=device)
    plain = time_ms(lambda: ops.decode_attention(q, k, v, n,
                                                 backend="cuda"), flush)
    with_lse = time_ms(lambda: ops.decode_attention(q, k, v, n, lse=lse,
                                                    backend="cuda"), flush)
    log(f"[time] decode_attention serve shape, bf16, length {L}: without "
        f"lse {plain:.4f} ms, with lse {with_lse:.4f} ms — median of 30, L2 "
        f"flushed (max |lse - plain| {worst:.3e} over every shape)")


def decode_one_launch(torch, ops, q, k, v, n) -> None:
    """B14 is one CUDA launch a call and carries nothing between calls: two
    calls are bitwise equal, and the profiler sees one kernel on the card
    (no combine kernel, no workspace memset)."""
    from torch.profiler import ProfilerActivity, profile
    a = ops.decode_attention(q, k, v, n, backend="cuda")
    b = ops.decode_attention(q, k, v, n, backend="cuda")
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError("decode_attention: two calls differ")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ops.decode_attention(q, k, v, n, backend="cuda")
        torch.cuda.synchronize()
    got = {e.key: e.count for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.is_user_annotation}
    if sum(got.values()) != 1 or "decode_cluster_kernel" not in next(
            iter(got)):
        raise AssertionError(f"decode_attention launched {got}: one "
                             "decode_cluster_kernel expected")
    log(f"  decode_attention serve: two calls bitwise equal; one launch a "
        f"call ({next(iter(got))})")


def tf_logits(torch, model, params, tokens, out, max_len, extra=None):
    """Logits of every generated position, teacher-forced through the
    serve path's own ops: prefill on the prompt (with ``extra``), then one
    decode step per generated token but the last. (B, G, Vp) float32."""
    kw = {} if extra is None else {"extra": extra}
    logits, cache = model.prefill(params, tokens, max_len, **kw)
    rows = [logits[:, 0]]
    P = tokens.shape[1]
    for t in range(out.shape[1] - 1):
        logits, cache = model.decode_step(params, cache, out[:, t:t + 1],
                                          P + t)
        rows.append(logits[:, 0])
    return torch.stack(rows, 1)


def hold_to_plain(torch, tag, eng, params, tokens, out, extra=None) -> None:
    """The kernel path's generate ``out`` held to the plain path
    (``backend="ref"``): teacher-forced logits of every generated position
    within TF_LOGIT_TOL, each row's greedy tokens equal to the plain
    generate's up to its first top-2 margin below TF_MARGIN, and every
    kernel-path token within 2 TF_LOGIT_TOL of the plain path's top
    logit."""
    from repro_torch.sparse import use_backend
    model, ML, V = eng.model, eng.max_len, eng.model.cfg.vocab_size
    B, G = out.shape
    lg_k = tf_logits(torch, model, params, tokens, out, ML, extra)
    with use_backend("ref"):
        lg_r = tf_logits(torch, model, params, tokens, out, ML, extra)
        out_r = eng.generate(params, tokens, G, extra=extra)
    if not bool(torch.isfinite(lg_k[..., :V]).all()):
        raise AssertionError(f"{tag}: non-finite logits on the kernel path")
    if not torch.equal(lg_k.argmax(-1).to(out.dtype), out):
        raise AssertionError(f"{tag}: teacher-forced argmax differs from "
                             "generate")
    dl = (lg_k - lg_r)[..., :V].abs().max().item()
    # bf16 logits tie often (a margin of 0 at the top), so each row is
    # compared up to its own first small margin
    top2 = lg_r.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]                  # (B, G)
    small = margin < TF_MARGIN
    first = torch.where(small.any(1), small.float().argmax(1),
                        torch.full((B,), G, device=out.device)).tolist()
    same = [bool(torch.equal(out[b, :f], out_r[b, :f]))
            for b, f in enumerate(first)]
    log(f"[{tag}] teacher-forced logits, kernels vs plain: max|diff| "
        f"{dl:.3e} (tol {TF_LOGIT_TOL}; max|logit| "
        f"{lg_r[..., :V].abs().max().item():.2f}); greedy "
        f"tokens identical per row up to its first top-2 margin < "
        f"{TF_MARGIN}: steps {first}; full match "
        f"{bool(torch.equal(out, out_r))} ({int((out == out_r).sum())} of "
        f"{B * G} tokens)")
    if not dl <= TF_LOGIT_TOL:
        raise AssertionError(f"{tag}: teacher-forced logits differ by "
                             f"{dl:.3e}")
    if not all(same):
        raise AssertionError(f"{tag}: greedy tokens differ before any small "
                             "margin")
    # every greedy token of the kernel path is the plain path's top token
    # up to the logits' tolerance, at every step of every row
    gap = (top2[..., 0] - lg_r.gather(-1, out.long()[..., None])[..., 0])
    log(f"[{tag}] kernel-path tokens under the plain path's teacher-forced "
        f"logits: at most {gap.max().item():.3e} below the top logit (tol "
        f"{2 * TF_LOGIT_TOL})")
    if not gap.max().item() <= 2 * TF_LOGIT_TOL:
        raise AssertionError(f"{tag}: a kernel-path token is not a "
                             "plain-path near-argmax")


def transformer_serve(torch, device):
    """Phase 5: qwen3-0.6b at full width in bf16 (weights from a CPU
    generator, seed 0) served greedily through ``ServeEngine``, B=8,
    prompt 512, gen 64, max_len 1024, with the launch counts set to 0 just
    before one generate and read just after: 28 B15 launches for the
    prefill, 28 B14 launches per decode step. Teacher-forced logits of the
    kernel path against the plain path within TF_LOGIT_TOL, each row's
    greedy tokens equal up to its first top-2 margin below TF_MARGIN; the
    ``--brds`` path (``transformer_policy(0.75, 0.5)``); then an
    ``lstm_ptb`` draft (packed, seed 7, rebound to the padded vocabulary)
    speculating k=4 with tokens equal to target-only. Returns the two
    kernels' launch counts from the dense run."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops
    from repro_torch.models import LSTMModel, LSTM_CONFIGS, build_model
    from repro_torch.serving import ServeEngine
    from repro_torch.sparse import (lstm_policy, transformer_policy,
                                    use_backend)
    from repro_torch.spec import DraftModel
    cfg = get_arch(TSERVE["arch"])
    B, P, G, ML = (TSERVE[k] for k in ("batch", "prompt", "gen", "max_len"))
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator().manual_seed(0), device)
    torch.cuda.synchronize()
    # K and V, 2 bytes an element
    kv_bytes = 4 * cfg.num_layers * B * ML * cfg.num_kv_heads * cfg.head_dim
    log(f"[tserve] {cfg.name}: {cfg.num_layers} layers d={cfg.d_model} "
        f"heads {cfg.num_heads}/{cfg.num_kv_heads}x{cfg.head_dim} "
        f"ff={cfg.d_ff} V={cfg.vocab_size} (padded {model.vocab_padded}) "
        f"{cfg.dtype}: {model.param_count() / 1e6:.1f}M params, init "
        f"{time.perf_counter() - t0:.2f}s (CPU generator, seed 0); KV "
        f"cache {kv_bytes / 1e9:.3f} GB")
    tokens = torch.randint(0, cfg.vocab_size, (B, P),
                           generator=torch.Generator().manual_seed(1)
                           ).to(device)
    eng = ServeEngine(model, max_len=ML, device=device)
    eng.generate(params, tokens, 2)                 # warm the libraries
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    eng.generate(params, tokens, G)                 # captures the G graph
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    log(f"[tserve] capturing the {G}-step decode graph: allocated "
        f"{(mem1[0] - mem0[0]) / 1e9:+.3f} GB, reserved "
        f"{(mem1[1] - mem0[1]) / 1e9:+.3f} GB (the {G}-step graph's pool "
        "and token buffer; the static KV cache is shared with the 2-step "
        f"graph's); in all {mem1[0] / 1e9:.3f} GB allocated, "
        f"{mem1[1] / 1e9:.3f} GB reserved")
    want = {"flash_attention": cfg.num_layers,
            "decode_attention": cfg.num_layers * G}

    def counted(tag, run):
        for k in ops.LAUNCHES:
            ops.LAUNCHES[k] = 0
        for k in kfa.BODIES:
            kfa.BODIES[k] = 0
        out = run()
        torch.cuda.synchronize()
        got = {k: n for k, n in ops.LAUNCHES.items() if n}
        log(f"[tserve] {tag}: launches {got}, B15 by body {kfa.BODIES}")
        return out, got

    out, got = counted("dense greedy", lambda: eng.generate(params, tokens,
                                                           G))
    if got != want:
        raise AssertionError(f"dense serve launched {got}, expected {want}: "
                             "28 B15 per prefill, 28 B14 per decode step")
    if kfa.BODIES != {"tensor_cores": cfg.num_layers, "simt": 0}:
        raise AssertionError(f"the bf16 prefill ran B15 as {kfa.BODIES}: "
                             "every launch must take the tensor cores")
    if out.shape != (B, G) or not bool(((out >= 0)
                                        & (out < cfg.vocab_size)).all()):
        raise AssertionError(f"bad tokens: shape {tuple(out.shape)}")
    dts = timed_runs(torch, lambda: eng.generate(params, tokens, G))
    med = statistics.median(dts)
    log(f"[tserve] dense greedy B={B} prompt={P} gen={G}: median {med:.4f}s "
        f"of {RUNS} runs ({B * G / med:.1f} tok/s, prefill included; range "
        f"{B * G / max(dts):.1f}-{B * G / min(dts):.1f} tok/s)")
    pre = timed_runs(torch, lambda: model.prefill(params, tokens, ML))
    log(f"[tserve] prefill alone: median {statistics.median(pre) * 1e3:.2f} "
        f"ms ({B * P / statistics.median(pre):.1f} prompt tok/s)")
    # the captured loop against the host loop it replaced
    _, state = eng.generate(params, tokens, G, return_state=True)
    from repro_torch.serving import runtime
    h_out, h_state = host_loop(eng, params, tokens, G)
    if not (torch.equal(out, h_out) and all(
            torch.equal(a, b) for a, b in zip(runtime.leaves(state),
                                              runtime.leaves(h_state)))):
        raise AssertionError("qwen3-0.6b: the captured decode loop differs "
                             "from the host loop")
    del state, h_state
    hts = timed_runs(torch, lambda: host_loop(eng, params, tokens, G), 2)
    # the peak allocated during one call, from what is allocated before it
    # (the engine's static KV cache and graph pools included)
    peak = {}
    for name, run in (("captured", lambda: eng.generate(params, tokens, G)),
                      ("host loop", lambda: host_loop(eng, params, tokens,
                                                      G))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        run()
        torch.cuda.synchronize()
        peak[name] = (before, torch.cuda.max_memory_allocated())
    log("[tserve] peak allocated during one generate: " + "; ".join(
        f"{k} {p / 1e9:.3f} GB ({(p - b) / 1e9:+.3f} GB over the "
        f"{b / 1e9:.3f} GB allocated before it)" for k, (b, p) in
        peak.items())
        + f"; the KV cache is {kv_bytes / 1e9:.3f} GB")
    busy, span, seen, n, _ = witnessed(torch, ops, "qwen3-0.6b captured",
                                    lambda: eng.generate(params, tokens, G))
    log(f"[graph] qwen3-0.6b: the profiled generate's launch counts equal "
        f"the profiler's kernels by symbol: {seen} (profiled runs taken: "
        f"{n})")
    pm = statistics.median(pre)
    row = {"path": "qwen3-0.6b dense", "batch": B,
           "captured_wall": (med - pm) / G,
           "host_wall": (statistics.median(hts) - pm) / G,
           "captured_busy": busy / G, "captured_span": span / G}
    GRAPH_ROWS.append(row)
    log(f"[graph] qwen3-0.6b B={B} prompt={P} gen={G}: tokens and state "
        f"(KV cache included) bitwise the host loop; wall / decode step "
        f"(generate minus the prefill, over {G}): captured "
        f"{row['captured_wall'] * 1e3:.3f} ms / host loop "
        f"{row['host_wall'] * 1e3:.3f} ms; device busy / step, prefill "
        f"included, captured {row['captured_busy'] * 1e3:.3f} ms (span "
        f"{row['captured_span'] * 1e3:.3f})")

    # the plain path: teacher-forced logits and greedy tokens
    hold_to_plain(torch, "tserve", eng, params, tokens, out)
    with use_backend("ref"):
        lr, _ = model.prefill(params, tokens, ML)
    log(f"[tserve] the plain path's prefill logits move "
        f"{one_ulp_spread(torch, model, params, tokens, ML, lr):.3e} when "
        "half the embedding's entries move one bf16 ulp")
    del lr

    # --brds: prune (no packing) through transformer_policy
    beng = ServeEngine(model, max_len=ML, device=device,
                       sparsity=transformer_policy(0.75, 0.5))
    t0 = time.perf_counter()
    pruned, report = beng.prepare(params)
    torch.cuda.synchronize()
    log(f"[tserve] --brds prepare {time.perf_counter() - t0:.2f}s: "
        f"sparsity {report['sparsity']:.4f} of {report['prunable_params']} "
        "prunable weights")
    beng.generate(pruned, tokens, G)                # captures its graph
    bout, bgot = counted("brds greedy", lambda: beng.generate(pruned, tokens,
                                                             G))
    if bgot != want or not bool(((bout >= 0)
                                 & (bout < cfg.vocab_size)).all()):
        raise AssertionError(f"--brds serve launched {bgot}, tokens "
                             f"{tuple(bout.shape)}")
    dts = timed_runs(torch, lambda: beng.generate(pruned, tokens, G))
    med = statistics.median(dts)
    log(f"[tserve] brds greedy: median {med:.4f}s of {RUNS} runs "
        f"({B * G / med:.1f} tok/s; range {B * G / max(dts):.1f}-"
        f"{B * G / min(dts):.1f})")
    del pruned

    # speculation: a packed lstm_ptb draft over the padded vocabulary
    dcfg = dataclasses.replace(LSTM_CONFIGS["lstm_ptb"],
                               vocab_size=model.vocab_padded)
    deng = ServeEngine(LSTMModel(dcfg), max_len=ML, device=device,
                       sparsity=lstm_policy(0.75, 0.5))
    dparams, _ = deng.prepare(deng.model.init(
        torch.Generator().manual_seed(7), device))
    draft = DraftModel(deng.model, dparams)
    eng.generate(params, tokens, G, draft=draft, spec_k=SPEC_K)  # captures
    (sout, st), sgot = counted("spec k=4 lstm_ptb draft", lambda: eng.generate(
        params, tokens, G, draft=draft, spec_k=SPEC_K, return_state=True))
    rounds = int(st["rounds"].max())
    ran = st["chunks"] * eng.spec_rounds
    swant = cfg.num_layers * (SPEC_K + 1) * ran
    if sgot.get("decode_attention") != swant or sgot.get(
            "flash_attention") != cfg.num_layers:
        raise AssertionError(f"spec launched {sgot}: expected {swant} B14 "
                             f"({st['chunks']} chunks of {eng.spec_rounds} "
                             f"rounds of {SPEC_K + 1} verify steps) and one "
                             "prefill's B15")
    same_tokens(torch, "qwen3-0.6b spec (lstm_ptb draft) vs target-only "
                "greedy", sout, out)
    acc, drafted = int(st["accepted"].sum()), int(st["drafted"].sum())
    dts = timed_runs(torch, lambda: eng.generate(
        params, tokens, G, draft=draft, spec_k=SPEC_K), runs=1)
    log(f"[tserve] spec k={SPEC_K}: acceptance {acc / max(drafted, 1):.4f} "
        f"({acc}/{drafted}), {rounds} rounds, {dts[0]:.4f}s "
        f"({B * G / dts[0]:.1f} tok/s), {dts[0] / rounds * 1e3:.3f} ms per "
        "round")
    return {k: got[k] for k in ATTN_KERNELS}


def scheduler_serve(torch, device):
    """Phase 8: ``ContinuousBatchingEngine`` at lstm_ptb's full width,
    packed float fused, 64 slots, over a closed-loop trace from
    ``traffic.loadgen`` (seed 0, 256 requests, prompts 8-64 tokens, budgets
    16-64), at dispatch depths 1 and 2 and with a self draft: every
    request's tokens equal at both depths and with the draft, and the
    first 32 requests' equal their ``ServeEngine`` B=1 greedy tokens (up
    to a top-2 margin below MARGIN: the head's GEMM may sum in another
    order at B=1 than at 64). Prints tok/s, TTFT and TPOT p50 / p99 from
    ``traffic.summarize`` and the device's busy share of a profiled run.
    Returns the rows for the record."""
    from repro_torch.kernels import ops
    from repro_torch.models import LSTMModel, LSTM_CONFIGS
    from repro_torch.serving import ServeEngine
    from repro_torch.serving.scheduler import ContinuousBatchingEngine
    from repro_torch.sparse import lstm_policy
    from repro_torch.spec import DraftModel
    from repro_torch.traffic import LoadConfig, make_prompts, poisson_trace
    from repro_torch.traffic import serve_trace
    cfg = LSTM_CONFIGS["lstm_ptb"]
    S, ML = SCHED["slots"], SCHED["max_len"]
    eng = ServeEngine(LSTMModel(cfg), max_len=ML, device=device,
                      sparsity=lstm_policy(0.75, 0.5))
    packed, _ = eng.prepare(LSTMModel(cfg).init(
        torch.Generator().manual_seed(0), device))
    lc = LoadConfig(rate=1000.0, num_requests=SCHED["requests"],
                    prompt_short=SCHED["prompt_short"],
                    prompt_long=SCHED["prompt_long"],
                    output_lens=SCHED["output_lens"],
                    seed=SCHED["load_seed"])
    trace = poisson_trace(lc)
    prompts = make_prompts(trace, cfg.vocab_size, seed=SCHED["load_seed"])
    warm = 32
    L, step_k = cfg.num_layers, "fused_brds_lstm_step"

    def run(depth, draft=None):
        """One scheduler: warmed on the trace's first requests (the chunk
        captured, the prefill widths warmed), then the whole trace with
        every launch count set to 0 just before it and held exactly just
        after: each prefill call's padded width x layers, and each chunk
        the capture's launches; without a draft, the trace once more under
        the profiler (the busy share), and one replay of the chunk graph
        with its launch counts held to the kernels the profiler saw."""
        sched = ContinuousBatchingEngine(eng.model, packed, slots=S,
                                         max_len=ML, dispatch_depth=depth,
                                         draft=draft, spec_k=SPEC_K,
                                         device=device)
        tokens, widths = {}, []
        real_step, real_prefill = sched.step, sched._prefill

        def step():
            fins = real_step()
            for f in fins:
                tokens[f.uid] = f.tokens
            return fins

        def prefill(model, params, group, padded, lengths_v):
            widths.append(group[0].prompt_len if padded is None
                          else padded.shape[1])
            return real_prefill(model, params, group, padded, lengths_v)

        sched.step, sched._prefill = step, prefill
        serve_trace(sched, trace[:warm], prompts[:warm], realtime=False)
        # a chunk: `chunk` decode steps (a draft: `chunk` rounds of k + 1
        # verify and k + 1 draft steps), one launch a layer each
        per_chunk = sched.chunk * L * (1 if draft is None
                                       else 2 * (SPEC_K + 1))
        if sched._loop.graph.launches != {step_k: per_chunk}:
            raise AssertionError(f"the scheduler's chunk graph holds "
                                 f"{sched._loop.graph.launches}, expected "
                                 f"{ {step_k: per_chunk} }")
        widths.clear()
        zero_launches(ops)
        first, chunks0 = sched._next_uid, sched.steps_dispatched
        recs, summ = serve_trace(sched, trace, prompts, realtime=False)
        torch.cuda.synchronize()
        got = {k: n for k, n in ops.LAUNCHES.items() if n}
        chunks = sched.steps_dispatched - chunks0
        want = {step_k: sum(widths) * L + chunks * per_chunk}
        log(f"[sched] slots={S} depth={depth}"
            + ("" if draft is None else ", self draft")
            + f": launches {got}, expected {want}: {len(widths)} prefill "
            f"calls of {sum(widths)} padded steps in all, x {L} layers, and "
            f"{chunks} chunks of {per_chunk} (the chunk graph's capture)")
        if got != want:
            raise AssertionError(f"scheduler launched {got}, expected "
                                 f"{want}")
        toks = [tokens[first + i] for i in range(len(trace))]
        prof = None
        if draft is None:
            zero_launches(ops)
            t = time.perf_counter()
            busy, span, ev = device_busy(torch, lambda: serve_trace(
                sched, trace, prompts, realtime=False), host_ops=False)
            wall = time.perf_counter() - t
            n = sum(1 for e in ev if "fused_staged_kernel" in e.name)
            log(f"[sched] depth={depth}, the trace again under the "
                f"profiler: {len(ev)} device events, B3 {n} of the "
                f"{ops.LAUNCHES[step_k]} counted")
            prof = busy, span, wall
            # one replay of the scheduler's chunk graph: its launch counts
            # held to the profiler's kernels (the runs above lack a few
            # records under the profiler, PERF.md §7)
            _, _, seen, n, _ = witnessed(
                torch, ops, f"scheduler depth {depth}, one chunk",
                sched._loop.run)
            if seen != {f"{step_k}/fused_brds_delta_lstm_step": per_chunk}:
                raise AssertionError(f"one chunk launched {seen}")
            log(f"[sched] depth={depth}, one replay of the chunk graph "
                f"under the profiler: launch counts equal its kernels by "
                f"symbol {seen} (profiled runs taken: {n})")
        return toks, summ, sched, got, prof

    rows = []
    results = {}
    for depth in (1, 2):
        toks, summ, sched, got, (busy, span, wall) = run(depth)
        results[depth] = toks
        # the profiler slows the host ~7x: the share is the profiled run's
        # device time over the unprofiled run's wall (the same trace and
        # tokens, so the same device work)
        row = dict(slots=S, depth=depth, draft=None, summary=summ,
                   busy_share=busy / summ["wall_s"])
        rows.append(row)
        log(f"[sched] slots={S} depth={depth}: {summ['completed']} of "
            f"{summ['requests']} requests, {summ['tokens']} tokens in "
            f"{summ['wall_s']:.3f}s: {summ['toks_per_s']} tok/s; TTFT p50 "
            f"{summ['p50_ttft_ms']} / p99 {summ['p99_ttft_ms']} ms; TPOT "
            f"p50 {summ['p50_tpot_ms']} / p99 {summ['p99_tpot_ms']} ms; "
            f"launches {got}; the same "
            f"run profiled on the card alone: device busy {busy:.3f}s (span "
            f"{span:.3f}s; its wall {wall:.3f}s), {row['busy_share']:.1%} "
            "of the unprofiled run's wall")
        if summ["completed"] != len(trace):
            raise AssertionError(f"scheduler completed {summ['completed']}")
    for a, b in zip(results[1], results[2]):
        if not np.array_equal(a, b):
            raise AssertionError("dispatch depth 1 and 2 decode differently")
    log(f"[sched] depths 1 and 2: all {len(trace)} requests' tokens equal")
    # the first requests against B=1 lockstep greedy
    checked = 0
    for i in range(SCHED["compared"]):
        p = torch.from_numpy(prompts[i]).to(device)
        n = len(results[2][i])
        want = eng.generate(packed, p, SCHED["output_lens"][1])[0, :n]
        got = torch.from_numpy(results[2][i]).to(device)
        if not torch.equal(got, want.to(got.dtype)):
            seq = torch.cat([p, want[None].long()], 1)
            lg = teacher_forced(torch, eng.model, packed, seq)[0,
                                                              p.shape[1] - 1:]
            top2 = lg.topk(2, dim=-1).values
            bad = int((got != want).nonzero()[0])
            margin = float(top2[bad, 0] - top2[bad, 1])
            log(f"[sched] request {i}: differs from B=1 at token {bad}, "
                f"top-2 margin {margin:.3e}")
            if margin >= MARGIN:
                raise AssertionError(f"request {i}: scheduler tokens differ "
                                     "from B=1 greedy above the margin")
        checked += 1
    log(f"[sched] the first {checked} requests: tokens equal their B=1 "
        "ServeEngine greedy tokens")
    # a self draft: the same tokens
    draft = DraftModel(eng.model, packed)
    toks, summ, sched, got, _ = run(2, draft=draft)
    for a, b in zip(results[2], toks):
        if not np.array_equal(a, b):
            raise AssertionError("the self draft changed a token")
    st = sched.spec_stats()
    rows.append(dict(slots=S, depth=2, draft="self", summary=summ,
                     busy_share=None))
    log(f"[sched] self draft, spec_k={SPEC_K}, depth 2: all {len(trace)} "
        f"requests' tokens equal the draft-free run's; {summ['tokens']} "
        f"tokens in {summ['wall_s']:.3f}s: {summ['toks_per_s']} tok/s; "
        f"TTFT p50 {summ['p50_ttft_ms']} / p99 {summ['p99_ttft_ms']} ms; "
        f"TPOT p50 {summ['p50_tpot_ms']} / p99 {summ['p99_tpot_ms']} ms; "
        f"acceptance {st['acceptance_rate']:.4f} ({st['accepted']}/"
        f"{st['drafted']}), {st['rounds']} rounds; launches {got}")
    return rows


def lstm_steps(torch, step_fn, params, opt, loader, device, steps,
               masks=None):
    """``steps`` train steps; returns (params, opt state, losses, ms per
    step). With ``masks``, after every step each pruned entry of the
    params and of the optimizer's moments (the masked gradients' sums: a
    nonzero gradient would make them nonzero) must be exactly 0."""
    losses, ms = [], []
    for step in range(steps):
        raw = loader.batch(step)
        batch = {"inputs": torch.as_tensor(raw["tokens"], device=device),
                 "labels": torch.as_tensor(raw["labels"], device=device)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, met = step_fn(params, opt, batch, step)
        losses.append(float(met["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
        for path, m in (masks or {}).items():
            _, i, key = path.split("/")
            for name, tree in (("param", params), ("m", opt["m"]),
                               ("v", opt["v"])):
                w = tree["layers"][int(i)][key]
                if bool(w[~m].any()):
                    raise AssertionError(f"step {step}: a pruned entry of "
                                         f"{path} ({name}) is not 0")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    return params, opt, losses, ms


def top_kernels(ev, n: int = 6) -> str:
    """The ``n`` device ops of a profiled run that took the most time,
    with their share of its busy time and their count."""
    tot, cnt = {}, {}
    for e in ev:
        d = e.time_range.end - e.time_range.start
        tot[e.name] = tot.get(e.name, 0) + d
        cnt[e.name] = cnt.get(e.name, 0) + 1
    busy = sum(tot.values()) or 1
    top = sorted(tot, key=tot.get, reverse=True)[:n]
    return "; ".join(f"{k[:60]} {tot[k] / busy:.1%} x{cnt[k]}" for k in top)


def grads_of(torch, loss_fn, params, batch):
    """{path: gradient or None} of every leaf, through autograd with
    unused leaves allowed (so a leaf the loss does not reach shows)."""
    from repro_torch.training.tree import leaves_with_keys, unflatten
    keyed = leaves_with_keys(params)
    flat = [t.detach().requires_grad_(True) for _, t in keyed]
    loss = loss_fn(unflatten(params, flat), batch)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    return loss.detach(), {k: g for (k, _), g in zip(keyed, grads)}


def training(torch, device):
    """Phase 9: training and the accuracy loop on the card.

    (a) lstm_ptb at full width (seed-0 weights) on ZipfInduction(10000),
        B=16, T=35: one dense step on the card against the same step on
        the CPU (loss, every gradient leaf, params); every leaf gets a
        gradient; 20 AdamW steps dense, then ``lstm_policy(0.75, 0.5)``
        and 20 masked steps, the loss lower at the end of each phase than
        at its start and every pruned entry (and its moments) exactly 0
        after every masked step; no kernel of the fifteen launched; ms a
        step and the busy share of one profiled step.
    (b) The four deployments of the retrained model (fp32 / int8 × Θ 0 /
        0.05) through ``pipeline.run_point``: served nll bitwise the
        manual one, each within NLL_RTOL of the same deployment on the
        plain versions, and each ``score`` launching exactly T × layers of
        its fused step kernel (B3, B5, B8, B9) and nothing else; tok/s.
    (c) ``launch.pipeline --smoke --gate 5``: the gate holds at (0.75,
        0.5), parity bitwise at all 8 points, the BENCH schema.
    (d) ``launch.train --arch qwen3-0.6b`` at full width (bf16) with
        ``--brds``, batch 4, seq 256, 6 steps, a checkpoint every 2 and a
        failure injected at 3: it resumes from step 2, every loss finite,
        none of the fifteen kernels launched (its training forward never
        reaches B15); then every attention weight's gradient is there and
        finite, and ms a step, the busy share and the peak memory."""
    import importlib.util
    import shutil
    import types
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import pipeline as pl
    from repro_torch.launch import train as launch_train
    from repro_torch.models import LSTMModel, LSTM_CONFIGS, build_model
    from repro_torch.sparse import (get_default_backend, lstm_policy,
                                    transformer_policy, use_backend)
    from repro_torch.training import (OptConfig, ShardedLoader,
                                      ZipfInduction, init_state,
                                      make_train_step)
    from repro_torch.training.tree import leaves
    rows = {}
    cfg = LSTM_CONFIGS["lstm_ptb"]
    B, T, N = TRAIN["batch"], TRAIN["seq"], TRAIN["steps"]
    model = LSTMModel(cfg)
    cpu_params = model.init(torch.Generator().manual_seed(0), "cpu")
    params = model.init(torch.Generator().manual_seed(0), device)
    corpus = ZipfInduction(vocab_size=cfg.vocab_size)
    loader = ShardedLoader(corpus, B, T)
    arch = types.SimpleNamespace(grad_accum=1)
    oc = OptConfig(lr=TRAIN["lr"], warmup_steps=1, total_steps=N)

    # (a) one dense step, card vs CPU, and every leaf's gradient
    raw = loader.batch(3)
    batch = {k: torch.as_tensor(raw[s]) for k, s in
             (("inputs", "tokens"), ("labels", "labels"))}
    gbatch = {k: v.to(device) for k, v in batch.items()}
    loss_c, g_c = grads_of(torch, model.loss, cpu_params, batch)
    loss_g, g_g = grads_of(torch, model.loss, params, gbatch)
    missing = [k for k, g in g_g.items() if g is None]
    if missing:
        raise AssertionError(f"leaves without a gradient: {missing}")
    gerr = max(float((g_g[k].cpu() - g_c[k]).abs().max())
               / max(float(g_c[k].abs().max()), 1e-30) for k in g_c)
    lerr = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    step_fn = make_train_step(model, arch, oc)
    p_c, _, m_c = step_fn(cpu_params, init_state(oc, cpu_params), batch, 3)
    p_g, _, m_g = step_fn(params, init_state(oc, params), gbatch, 3)
    diffs = [(a.cpu() - b).abs() for a, b in zip(leaves(p_g), leaves(p_c))]
    perr = max(float(d.max()) for d in diffs)
    beyond = sum(int((d > 1e-6).sum()) for d in diffs) / sum(
        d.numel() for d in diffs)
    log(f"[train] lstm_ptb one dense step, card vs CPU (B={B}, T={T}): loss "
        f"{float(loss_g):.6f} vs {float(loss_c):.6f} (rel {lerr:.2e}, gate "
        f"{STEP_LOSS_RTOL}); gradients: every one of {len(g_g)} leaves "
        f"present, max |Δg| / max |g| {gerr:.2e} (gate {STEP_GRAD_RTOL}); "
        f"grad norm {float(m_g['grad_norm']):.6f} vs "
        f"{float(m_c['grad_norm']):.6f}; params after the step max |Δ| "
        f"{perr:.2e} (gate {STEP_PARAM_ATOL:.0e}), {beyond:.2e} of entries "
        f"beyond 1e-6 (gate {STEP_PARAM_SHARE:.0e})")
    if lerr > STEP_LOSS_RTOL or gerr > STEP_GRAD_RTOL \
            or perr > STEP_PARAM_ATOL or beyond > STEP_PARAM_SHARE:
        raise AssertionError("the card's dense step differs from the CPU's")
    del cpu_params, p_c, p_g, g_c, g_g

    # (a) 20 dense steps, then 20 masked at (0.75, 0.5)
    zero_launches(ops)
    params, opt, dense_losses, ms = lstm_steps(
        torch, step_fn, params, init_state(oc, params), loader, device,
        N)
    pruned, masks = lstm_policy(0.75, 0.5).compile(params).prune(params)
    roc = OptConfig(lr=TRAIN["retrain_lr"], warmup_steps=1, total_steps=N)
    retrain_fn = make_train_step(model, arch, roc, masks)
    retrained, ropt, re_losses, rms = lstm_steps(
        torch, retrain_fn, pruned, init_state(roc, pruned), loader,
        device, N, masks=masks)
    torch.cuda.synchronize()
    if any(ops.LAUNCHES.values()):
        raise AssertionError(f"training launched kernels: {ops.LAUNCHES}")
    busy, span, ev = device_busy(torch, lambda: retrain_fn(
        retrained, ropt, gbatch, N))
    wall = statistics.median(rms[1:])
    log(f"[train] lstm_ptb dense: loss {dense_losses[0]:.4f} -> "
        f"{dense_losses[-1]:.4f} over {N} AdamW steps (lr {TRAIN['lr']}); "
        f"masked retrain at (0.75, 0.5): {re_losses[0]:.4f} -> "
        f"{re_losses[-1]:.4f} (lr {TRAIN['retrain_lr']}), every pruned "
        f"entry and its moments exactly 0 after all {N} steps; no kernel "
        f"launched")
    log(f"[train] lstm_ptb ms a step: dense median "
        f"{statistics.median(ms[1:]):.2f} (range {min(ms[1:]):.2f}-"
        f"{max(ms[1:]):.2f}), masked {wall:.2f}; one profiled masked "
        f"step: device busy {busy * 1e3:.2f} ms (span {span * 1e3:.2f}), "
        f"busy share {busy * 1e3 / wall:.1%} of the median wall; "
        f"{len(ev)} device ops, the most time: {top_kernels(ev)}")
    rows["lstm_ptb"] = dict(ms=wall, busy_ms=busy * 1e3)
    del opt, ropt

    # (b) the four deployments through run_point, each score counted
    pcfg = pl.PipelineConfig(corpus="zipf", vocab=cfg.vocab_size,
                             embed=cfg.input_size, hidden=cfg.hidden,
                             batch=B, seq_len=T, eval_batches=2,
                             eval_batch=B, eval_seq=T, gen_batch=8,
                             gen_prompt=32, gen_steps=64, device="cuda")
    _, lcfg = pl.build_task(pcfg)
    eval_set = corpus.eval_batches(2, B, T)
    calib = pl._as_model_batch(corpus.batch(1 << 41, B, T), device)["inputs"]
    gen_raw = corpus.batch(1 << 42, 8, T)
    kernel_of = {(False, False): "fused_brds_lstm_step",
                 (True, False): "fused_brds_delta_lstm_step",
                 (False, True): "fused_brds_lstm_step_q8",
                 (True, True): "fused_brds_delta_lstm_step_q8"}
    orig_score = LSTMModel.score
    scores = []

    def counted_score(self, params_, inputs, labels=None):
        zero_launches(ops)
        out = orig_score(self, params_, inputs, labels)
        torch.cuda.synchronize()
        got = {k: n for k, n in ops.LAUNCHES.items() if n}
        want = {}
        if self.is_packed(params_) and get_default_backend() != "ref":
            name = kernel_of[(self.delta is not None,
                              self.is_quantized(params_))]
            want = {name: inputs.shape[1] * self.cfg.num_layers}
        if got != want:
            raise AssertionError(f"score launched {got}, expected {want}")
        scores.append(got)
        return out

    LSTMModel.score = counted_score
    try:
        for scheme in (None, "int8"):
            for theta in (0.0, 0.05):
                tag = f"{scheme or 'fp32'} theta={theta}"
                n0 = len(scores)
                point = pl.run_point(LSTMModel(lcfg), lcfg, retrained, pcfg,
                                     0.75, 0.5, scheme, theta, eval_set,
                                     calib, gen_raw)
                n1 = len(scores)
                policy = pl._policy_at(pcfg, 0.75, 0.5, scheme, theta)
                with use_backend("ref"):
                    pm, pp, _ = pl.prepare_manual(
                        LSTMModel(lcfg), policy, retrained,
                        calib=calib if scheme else None)
                    plain = pl.evaluate(pm, pp, eval_set)
                nll = point["metrics"]["nll"]
                rel = abs(nll - plain["nll"]) / plain["nll"]
                log(f"[train] deployment {tag}: served nll {nll:.6f} "
                    f"bitwise the manual route's; plain versions "
                    f"{plain['nll']:.6f} (rel {rel:.2e}, gate {NLL_RTOL}); "
                    f"ppl {point['metrics']['ppl']:.3f}; "
                    f"{point['weight_bytes']} weight bytes; score launches "
                    f"{scores[n0:n1]} (T x layers = {T}); "
                    f"{point['toks_per_s']:.1f} tok/s (generate B=8, "
                    f"prompt 32, gen 64)")
                if rel > NLL_RTOL:
                    raise AssertionError(f"{tag}: kernel and plain nll "
                                         "differ")
                if n1 - n0 != 2 * len(eval_set) or \
                        any(not c for c in scores[n0:n1]):
                    raise AssertionError(f"{tag}: unexpected score calls "
                                         f"{scores[n0:n1]}")
                rows[f"deploy {tag}"] = dict(
                    nll=nll, ppl=point["metrics"]["ppl"],
                    toks_per_s=point["toks_per_s"])

        # (c) the smoke pipeline through its CLI on the card
        out_dir = ROOT / "build" / "pipeline_smoke"
        t0 = time.perf_counter()
        rc = pl.main(["--smoke", "--gate", "5", "--out", str(out_dir)])
        wall = time.perf_counter() - t0
    finally:
        LSTMModel.score = orig_score
    payload = json.loads((out_dir / "BENCH_pipeline.json").read_text())
    spec = importlib.util.spec_from_file_location(
        "check_bench_schema", ROOT / "scripts" / "check_bench_schema.py")
    checker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(checker)
    checker.check_pipeline("BENCH_pipeline.json", payload)
    parity = payload["rows"][-1]
    if rc != 0 or payload["gate"]["ppl_delta_pct"] > 5.0 or \
            parity["bitwise"] != 1 or parity["points"] != 8:
        raise AssertionError(f"pipeline smoke: rc {rc}, gate "
                             f"{payload['gate']}, parity {parity}")
    for r in payload["rows"]:
        log("[pipeline] " + json.dumps(r))
    log(f"[pipeline] --smoke --gate 5 on the card: exit {rc}, wall "
        f"{wall:.1f}s (payload wall_time_s {payload['wall_time_s']}), gate "
        f"{payload['gate']['ppl_delta_pct']:+.2f}% at (0.75, 0.5), parity "
        f"bitwise at {parity['points']} points, {len(scores)} score calls "
        f"counted")
    rows["pipeline"] = dict(wall_s=wall, gate=payload["gate"],
                            ppl={r["name"]: r["ppl"] for r in payload["rows"]
                                 if "ppl" in r})
    del retrained, params, pruned

    # (d) launch.train at qwen3-0.6b's full width
    ck = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    zero_launches(ops)
    import repro_torch.configs as configs
    whole_arch = configs.get_arch
    configs.get_arch = lambda name: whole_arch(name).with_(
        num_layers=TTRAIN_LAYERS)
    t0 = time.perf_counter()
    try:
        out = launch_train.main(TTRAIN + ["--ckpt-dir", str(ck)])
    finally:
        configs.get_arch = whole_arch
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    ck_bytes = sum(f.stat().st_size for f in ck.rglob("*") if f.is_file())
    shutil.rmtree(ck, ignore_errors=True)
    losses = out["losses"]
    log(f"[train] launch.train {' '.join(TTRAIN)} ({TTRAIN_LAYERS} of 28 "
        f"layers): resumed from "
        f"{out['resumed_from']}, losses "
        f"{[round(losses[k], 4) for k in sorted(losses)]}, ms a step "
        f"{[round(out['step_ms'][k], 1) for k in sorted(out['step_ms'])]}; "
        f"{wall:.1f}s in all; peak memory {peak / 1e9:.2f} GB over the "
        f"{base / 1e9:.2f} GB allocated before; checkpoints on disk at the "
        f"end {ck_bytes / 1e9:.2f} GB; kernel launches "
        f"{ {k: n for k, n in ops.LAUNCHES.items() if n} }")
    if out["resumed_from"] != [2] or out["final_step"] != 4 or \
            sorted(losses) != list(range(4)) or \
            not all(np.isfinite(v) for v in losses.values()):
        raise AssertionError(f"launch.train: {out}")
    if any(ops.LAUNCHES.values()):
        raise AssertionError("qwen3-0.6b training launched a kernel (its "
                             f"forward reached B15?): {ops.LAUNCHES}")

    # every attention weight's gradient, and a profiled step
    tcfg = get_arch("qwen3-0.6b")
    tmodel = build_model(tcfg)
    tparams = tmodel.init(torch.Generator().manual_seed(0), device)
    tparams, tmasks = transformer_policy(0.75, 0.5).compile(tparams).prune(
        tparams)
    traw = ZipfInduction(vocab_size=tcfg.vocab_size).batch(0, 4, 256)
    tbatch = {k: torch.as_tensor(v, device=device) for k, v in traw.items()}
    tloss, tg = grads_of(torch, tmodel.loss, tparams, tbatch)
    bad = [k for k, g in tg.items() if g is None or not bool(
        torch.isfinite(g).all())]
    attn = [k for k in tg if any(f"['{n}']" in k for n in ATTN_LEAVES)]
    dead = [k for k in attn if not bool(tg[k].any())]
    log(f"[train] qwen3-0.6b gradients: {len(tg)} leaves, every one "
        f"present and finite: {not bad}; {len(attn)} attention leaves "
        f"(wq wk wv wo q_norm k_norm x {tcfg.num_layers} layers), nonzero: "
        f"{len(attn) - len(dead)}; loss {float(tloss):.4f}")
    if bad or dead or len(attn) != len(ATTN_LEAVES) * tcfg.num_layers:
        raise AssertionError(f"qwen3-0.6b gradients: missing or not finite "
                             f"{bad}, all zero {dead}")
    del tg
    toc = OptConfig(lr=3e-4, warmup_steps=1, total_steps=6)
    tstep = make_train_step(tmodel, tcfg, toc, tmasks)
    topt = init_state(toc, tparams)
    tms = []
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tparams, topt, _ = tstep(tparams, topt, tbatch, i)
        torch.cuda.synchronize()
        tms.append((time.perf_counter() - t0) * 1e3)
    busy, span, ev = device_busy(torch, lambda: tstep(tparams, topt, tbatch,
                                                      4))
    twall = statistics.median(tms[1:])
    log(f"[train] qwen3-0.6b masked train step (B=4, S=256, bf16): "
        f"{twall:.2f} ms (runs {[round(t, 2) for t in tms]}); one profiled "
        f"step: busy {busy * 1e3:.2f} ms (span {span * 1e3:.2f}), busy share "
        f"{busy * 1e3 / twall:.1%}; {len(ev)} device ops, the most time: "
        f"{top_kernels(ev)}")
    rows["qwen3-0.6b"] = dict(ms=twall, busy_ms=busy * 1e3,
                              peak_gb=peak / 1e9, cli_ms=out["step_ms"])
    return rows


def recurrent_serve(torch, device) -> None:
    """Phase 10: the recurrent families at full width in bf16 through
    ``ServeEngine``, greedy, one after the other (each model freed before
    the next). Weights come from a seeded CUDA generator (seed 0): ~18 B
    normal draws on the CPU would take minutes, and the plain path they
    are held to uses the same weights.

    With these random weights both models are chaotic in bf16: one bf16
    ulp on half the embedding's entries moves the plain path's own
    logits by as much as the logits themselves (``one_ulp_spread``,
    printed), where it moves qwen3-0.6b's by ~0.05. Kernels that round
    otherwise than the plain versions (B14 / B15: within one ulp) cannot
    keep such layers' tokens; so recurrentgemma-9b's attention is held
    launch by launch on the model's own inputs, and the end-to-end gates
    on the same configuration cut to one period at full width. Both run
    cut in depth (RSERVE's ``layers``; widths whole).

    - recurrentgemma-9b (6 layers: 2 periods), B=4, prompt 2560 (past the
      window of 2048), gen 64: the launch counts set to 0 just before one
      generate and read just after, exactly one B15 launch an attention
      layer for the prefill (every one on the tensor-core body) and one
      B14 launch an attention layer a decode step; every launch of its
      teacher-forced run within one bf16 ulp of its plain version on the
      same inputs (``held_calls``); the scheduler: 8 slots, 16 requests
      (prompts 8-64, budgets 16-32), each prefill's B15 and each chunk
      graph's 8 B14 launches an attention layer held exactly. Then one
      period (rec, rec, attn_local; the full model's first three layers
      and embedding) at full width: 1 B15 a prefill
      and 1 B14 a step, teacher-forced logits and greedy tokens held to
      the plain path at qwen3-0.6b's bf16 gates (``hold_to_plain``), and
      the scheduler again, four requests' tokens equal to lockstep B=1
      up to a top-2 margin below TF_MARGIN (a GEMM may sum in another
      order at B=1 than at 8).
    - rwkv6-7b, B=8, prompt 512, gen 64: no attention kernel launches,
      so the kernel path is the plain path (``hold_to_plain``: equal);
      then a packed lstm_ptb draft rebound to its 65536-token vocabulary
      speculating k=4 (its prompt primed by B12, one launch; each round
      k+1 B3 launches), its tokens equal to target-only.

    Each full model's captured decode loop is held bitwise to the host
    loop; each prints the wall a decode step, the prefill's ms, the
    device's busy share of one profiled generate and the peak memory of
    one generate. Last, ``launch.serve --arch lstm_ptb --brds
    --scorecard --metrics`` on the card."""
    import dataclasses
    import gc
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops
    from repro_torch.models import LSTMModel, LSTM_CONFIGS, build_model
    from repro_torch.serving import ServeEngine, runtime
    from repro_torch.sparse import lstm_policy, use_backend
    from repro_torch.spec import DraftModel
    for arch in ("recurrentgemma-9b", "rwkv6-7b"):
        t_arch = time.perf_counter()
        laps, t_lap = {}, [t_arch]

        def lap(name):
            now = time.perf_counter()
            laps[name] = round(now - t_lap[0], 1)
            t_lap[0] = now
        R = RSERVE[arch]
        full = get_arch(arch)
        cfg = full.with_(num_layers=R.get("layers", full.num_layers))
        B, P, G = R["batch"], R["prompt"], R["gen"]
        ML = P + G
        model = build_model(cfg)
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device).manual_seed(0), device)
        torch.cuda.synchronize()
        n_attn = sum(k.startswith("attn") for k in model.kinds)
        cache_bytes = sum(math.prod(d.shape) * d.dtype.itemsize
                          for d in runtime.leaves(model.cache_defs(B, ML)))
        log(f"[rserve] {arch}: {cfg.num_layers} of {full.num_layers} layers "
            f"{model.kinds[:3]}... "
            f"d={cfg.d_model} ff={cfg.d_ff} V={cfg.vocab_size} {cfg.dtype}: "
            f"{model.param_count() / 1e9:.3f} B params "
            f"({model.param_count() * 2 / 1e9:.2f} GB), init "
            f"{time.perf_counter() - t0:.2f}s (CUDA generator, seed 0); "
            f"{n_attn} attention layers; decode cache at B={B}, "
            f"max_len {ML}: {cache_bytes / 1e6:.1f} MB")
        tokens = torch.randint(0, cfg.vocab_size, (B, P),
                               generator=torch.Generator().manual_seed(1)
                               ).to(device)
        lap("init")
        eng = ServeEngine(model, max_len=ML, device=device)
        eng.generate(params, tokens, 2)             # warm the libraries
        eng.generate(params, tokens, G)             # captures the G graph
        torch.cuda.synchronize()
        zero_launches(ops)
        for k in kfa.BODIES:
            kfa.BODIES[k] = 0
        out = eng.generate(params, tokens, G)
        torch.cuda.synchronize()
        got = {k: n for k, n in ops.LAUNCHES.items() if n}
        want = ({"flash_attention": n_attn, "decode_attention": n_attn * G}
                if n_attn else {})
        log(f"[rserve] {arch} greedy B={B} prompt={P} gen={G}: launches "
            f"{got}, expected {want}; B15 by body {kfa.BODIES}")
        if got != want or kfa.BODIES["simt"] or \
                kfa.BODIES["tensor_cores"] != n_attn:
            raise AssertionError(f"{arch} launched {got} ({kfa.BODIES}), "
                                 f"expected {want}, every B15 on the "
                                 "tensor cores")
        if out.shape != (B, G) or not bool(((out >= 0)
                                            & (out < cfg.vocab_size)).all()):
            raise AssertionError(f"{arch}: bad tokens {tuple(out.shape)}")
        lap("captures and the counted generate")
        dts = timed_runs(torch, lambda: eng.generate(params, tokens, G),
                         RRUNS)
        pre = timed_runs(torch, lambda: model.prefill(params, tokens, ML),
                         RRUNS)
        med, pm = statistics.median(dts), statistics.median(pre)
        # the captured loop against the host loop it replaced (timed);
        # the peak allocated during the captured generate
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        _, state = eng.generate(params, tokens, G, return_state=True)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        hts = []
        h_out, h_state = timed_call(torch, hts, lambda: host_loop(
            eng, params, tokens, G))
        if not (torch.equal(out, h_out) and all(
                torch.equal(a, b) for a, b in zip(runtime.leaves(state),
                                                  runtime.leaves(h_state)))):
            raise AssertionError(f"{arch}: the captured decode loop differs "
                                 "from the host loop")
        del state, h_state
        lap("timed runs, host loop")
        busy, span, seen, n, ev = witnessed(
            torch, ops, f"{arch} captured",
            lambda: eng.generate(params, tokens, G), host_ops=False)
        row = {"path": f"{arch} dense", "batch": B,
               "captured_wall": (med - pm) / G,
               "host_wall": (statistics.median(hts) - pm) / G,
               "captured_busy": busy / G, "captured_span": span / G}
        GRAPH_ROWS.append(row)
        log(f"[rserve] {arch}: generate median {med:.4f}s of {RRUNS} "
            f"({B * G / med:.1f} tok/s, prefill included); prefill "
            f"{pm * 1e3:.2f} ms ({B * P / pm:.1f} prompt tok/s); wall / "
            f"decode step (generate minus prefill, over {G}) captured "
            f"{row['captured_wall'] * 1e3:.3f} ms, host loop "
            f"{row['host_wall'] * 1e3:.3f} ms; the profiled generate: "
            f"device busy {busy * 1e3:.2f} ms (span {span * 1e3:.2f}), "
            f"{busy / med:.1%} of the unprofiled generate's wall; launch "
            f"counts equal the profiler's kernels by symbol {seen} (runs "
            f"{n}); peak allocated during one generate "
            f"{peak / 1e9:.3f} GB ({(peak - before) / 1e9:+.3f} GB over the "
            f"{before / 1e9:.3f} GB before it); tokens and state bitwise "
            f"the host loop; the most device time: {top_kernels(ev)}")
        del ev
        # how far one bf16 ulp moves the plain path's own logits (a model
        # whose logits it decorrelates cannot be held to the plain path's
        # tokens by kernels that round otherwise)
        lap("profiled generate")
        with use_backend("ref"):
            lr, _ = model.prefill(params, tokens, ML)
        gap = "none launched"
        if n_attn:
            lk, _ = model.prefill(params, tokens, ML)
            gap = f"{(lk - lr)[..., :cfg.vocab_size].abs().max().item():.3e}"
            del lk
        spread = one_ulp_spread(torch, model, params, tokens, ML, lr)
        log(f"[rserve] {arch} prefill logits: kernels vs plain {gap}; "
            f"the plain path itself moves {spread:.3e} when half the "
            f"embedding's entries move one bf16 ulp (max|logit| "
            f"{lr[..., :cfg.vocab_size].abs().max().item():.2f})")
        del lr
        lap("one-ulp spread")
        if arch == "recurrentgemma-9b":
            # the full model decorrelates under one ulp: every B14 / B15
            # launch of its teacher-forced run held to its plain version on
            # the model's own inputs, the end-to-end gates on one period
            calls, err, scale = held_calls(torch, lambda: tf_logits(
                torch, model, params, tokens, out, ML))
            log(f"[rserve] {arch}: all {calls} B14 / B15 launches of the "
                f"teacher-forced run (prefill + {G - 1} steps) within one "
                f"bf16 ulp of their largest output of their plain versions "
                f"on the same inputs (max |err| {err:.3e}, max |output| "
                f"{scale:.3e})")
            if calls != n_attn * G:
                raise AssertionError(f"{calls} attention calls held, "
                                     f"expected {n_attn * G}")
            lap("held launches")
            zoo_scheduler(torch, device, model, params, compare=False)
            lap("scheduler")
            del eng, params, model, out
            gc.collect()
            torch.cuda.empty_cache()
            model = build_model(cfg.with_(num_layers=len(cfg.block_pattern)))
            params = model.init(torch.Generator(device).manual_seed(0),
                                device)
            eng = ServeEngine(model, max_len=ML, device=device)
            eng.generate(params, tokens, G)         # captures the G graph
            zero_launches(ops)
            out = eng.generate(params, tokens, G)
            torch.cuda.synchronize()
            got = {k: n for k, n in ops.LAUNCHES.items() if n}
            log(f"[rserve] {arch} cut to one period ({model.kinds}) at full "
                f"width: launches {got}")
            if got != {"flash_attention": 1, "decode_attention": G}:
                raise AssertionError(f"the one-period model launched {got}")
            hold_to_plain(torch, "rserve", eng, params, tokens, out)
            zoo_scheduler(torch, device, model, params, compare=True)
            lap("one period: serve, plain path, scheduler")
        else:
            hold_to_plain(torch, "rserve", eng, params, tokens, out)
            lap("plain path")
            dcfg = dataclasses.replace(LSTM_CONFIGS["lstm_ptb"],
                                       vocab_size=model.vocab_padded)
            deng = ServeEngine(LSTMModel(dcfg), max_len=ML, device=device,
                               sparsity=lstm_policy(0.75, 0.5))
            dparams, _ = deng.prepare(deng.model.init(
                torch.Generator().manual_seed(7), device))
            draft = DraftModel(deng.model, dparams, scan_prefill=True)
            eng.generate(params, tokens, G, draft=draft, spec_k=SPEC_K)
            zero_launches(ops)
            sdt = []
            sout, st = timed_call(torch, sdt, lambda: eng.generate(
                params, tokens, G, draft=draft, spec_k=SPEC_K,
                return_state=True))
            sgot = {k: v for k, v in ops.LAUNCHES.items() if v}
            ran = st["chunks"] * eng.spec_rounds
            swant = {"fused_brds_lstm_scan": dcfg.num_layers,
                     "fused_brds_lstm_step": dcfg.num_layers * (SPEC_K + 1)
                     * ran}
            if sgot != swant:
                raise AssertionError(f"{arch} spec launched {sgot}, "
                                     f"expected {swant}")
            same_tokens(torch, f"{arch} spec (lstm_ptb draft, V="
                        f"{dcfg.vocab_size}) vs target-only greedy", sout,
                        out)
            acc, drafted = int(st["accepted"].sum()), int(st["drafted"].sum())
            sdt = sdt[0]
            log(f"[rserve] {arch} spec k={SPEC_K}: launches {sgot}; "
                f"acceptance {acc / max(drafted, 1):.4f} ({acc}/{drafted}), "
                f"{int(st['rounds'].max())} rounds, {sdt:.4f}s "
                f"({B * G / sdt:.1f} tok/s)")
            del deng, dparams, draft, st
            lap("spec")
        del eng, params, model, out
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[rserve] {arch}: {time.perf_counter() - t_arch:.1f}s; by part "
            f"{laps}")
    # observability: the serve CLI's scorecard and metrics on the card
    import contextlib
    import io
    from repro_torch.launch import serve as serve_cli
    mpath = ROOT / "build" / "chip_smoke_metrics.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_cli.main(["--arch", "lstm_ptb", "--brds", "--batch", "8",
                        "--prompt-len", "32", "--gen", "64", "--scorecard",
                        "--metrics", str(mpath)])
    text = buf.getvalue()
    for ln in text.splitlines():
        log(f"[obs] {ln}")
    js = json.loads(mpath.read_text())
    mpath.unlink()
    if ("effective GOPS" not in text or "3.35 TB/s" not in text
            or js["dev_tokens"]["value"] != 8 * 64):
        raise AssertionError("launch.serve --scorecard --metrics: no "
                             "scorecard or wrong counters")


def one_ulp_spread(torch, model, params, tokens, ML, logits,
                   extra=None) -> float:
    """The largest change of the plain path's prefill ``logits`` (with
    ``extra``) when half the embedding's entries (chosen by a seeded
    generator) move one bf16 ulp up in magnitude."""
    from repro_torch.sparse import use_backend
    emb = params["embed"]["table"]
    g = torch.Generator(emb.device).manual_seed(3)
    bump = (torch.rand(emb.shape, generator=g, device=emb.device)
            < 0.5).to(torch.int16)
    moved = (emb.view(torch.int16) + bump).view(emb.dtype)
    del bump
    kw = {} if extra is None else {"extra": extra}
    with use_backend("ref"):
        b, _ = model.prefill(dict(params, embed={"table": moved}), tokens,
                             ML, **kw)
    return (logits - b)[..., :model.cfg.vocab_size].abs().max().item()


def held_calls(torch, run) -> tuple[int, float, float]:
    """``run`` with every B15 / B14 call the model makes (the default
    backend, on the card: the kernels) also computed by its plain version
    on the same inputs and held to it within one bf16 ulp of the call's
    largest output. (Random weights give this model scores in the
    thousands: its softmax is near one-hot, float32 rounding of a score
    in another order moves p by ~1e-3 relative, and an output near
    cancellation moves by more than one ulp of itself; a wrong key or
    mask moves it by the size of V.) The first B15 call is also computed
    in float64, and both sides' distances from it are printed. Returns
    (the calls held, the largest |kernel - plain|, the largest output).
    A B14 call with ``lse=`` also has its log-sum-exp held (``hold_lse``);
    the plain version writes its own."""
    from repro_torch.kernels import ops
    real = {n: getattr(ops, n) for n in ATTN_KERNELS}
    seen = dict(calls=0, err=0.0, scale=0.0)

    def holding(name):
        def call(*a, backend=None, **kw):
            got = real[name](*a, backend=backend, **kw)
            if backend is None:
                kw_ref = dict(kw)
                lse = kw.get("lse")
                if lse is not None:     # the plain version's own lse
                    kw_ref["lse"] = torch.empty_like(lse)
                want = real[name](*a, backend="ref", **kw_ref).float()
                if lse is not None:
                    hold_lse(torch, lse, kw_ref["lse"])
                if name == "flash_attention" and not seen["calls"]:
                    exact = flash_f64(torch, *a, **kw)
                    log(f"  the model's first B15 call, (B, Hq, S, D) "
                        f"{tuple(a[0].shape)}: |kernel - float64| "
                        f"{(got.double() - exact).abs().max().item():.3e}, "
                        f"|plain - float64| "
                        f"{(want.double() - exact).abs().max().item():.3e}, "
                        f"max |float64| {exact.abs().max().item():.3e}")
                    del exact
                d = (got.float() - want).abs().max().item()
                scale = want.abs().max().item()
                if not d <= BF16_ULP * scale:
                    raise AssertionError(f"{name} in the model: max |kernel "
                                         f"- plain| {d:.3e} past one bf16 ulp "
                                         f"of its largest output {scale:.3e}")
                seen["calls"] += 1
                seen["err"] = max(seen["err"], d)
                seen["scale"] = max(seen["scale"], scale)
            return got
        return call

    for n in ATTN_KERNELS:
        setattr(ops, n, holding(n))
    try:
        run()
    finally:
        for n, f in real.items():
            setattr(ops, n, f)
    return seen["calls"], seen["err"], seen["scale"]


def hold_lse(torch, got, want) -> None:
    """B14's log-sum-exp against its plain version's on the same inputs:
    -inf exactly where a row has no live key, else within LSE_ATOL of
    max(1, |lse|) (a logf of float32 sums in another order)."""
    dead = torch.isneginf(want)
    if not torch.equal(torch.isneginf(got), dead):
        raise AssertionError("B14's lse: rows with no live key differ")
    e = ((got - want).abs() / want.abs().clamp_min(1))[~dead]
    if e.numel() and not e.max().item() <= LSE_ATOL:
        raise AssertionError(f"B14's lse {e.max().item():.3e} of max(1, "
                             f"|lse|) from the plain version's")


def flash_f64(torch, q, k, v, *, causal=True, window=None):
    """B15's function in float64 (the plain version's masks): q (B, Hq,
    Sq, D), k/v (B, Hkv, Sk, D), q rows right-aligned to the kv end."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    qd = q.double().reshape(B, Hkv, Hq // Hkv, Sq, D) * D ** -0.5
    s = torch.einsum("bhgqd,bhkd->bhgqk", qd, k.double())
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=q.device)[None]
    live = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        live &= qpos >= kpos
    if window is not None:
        live &= kpos > qpos - window
    p = torch.softmax(s.masked_fill(~live, float("-inf")), -1)
    return torch.einsum("bhgqk,bhkd->bhgqd", p, v.double()).reshape(
        B, Hq, Sq, D)


def zoo_scheduler(torch, device, model, params, *, compare) -> None:
    """A zoo model (recurrentgemma-9b, granite-moe-1b-a400m) under
    ``ContinuousBatchingEngine``: RSCHED's slots and requests
    (exact-length prefill: the model is not length-aware), warmed on the
    first requests, then all of them with
    the launch counts set to 0 just before and held just after: a
    prefill call's B15 a layer, and each chunk its graph's capture (8
    steps x B14 a layer). ``compare``: the first four requests' tokens
    equal their ServeEngine B=1 greedy tokens up to a top-2 margin below
    TF_MARGIN."""
    from repro_torch.kernels import ops
    from repro_torch.serving import ServeEngine
    from repro_torch.serving.scheduler import ContinuousBatchingEngine
    C = RSCHED
    V, ML = model.cfg.vocab_size, C["max_len"]
    n_attn = sum(k.startswith("attn") for k in model.kinds)
    g = np.random.default_rng(0)
    reqs = [(g.integers(0, V, (1, int(g.integers(C["prompt"][0],
                                                 C["prompt"][1] + 1)))),
             int(g.integers(C["budget"][0], C["budget"][1] + 1)))
            for _ in range(C["requests"])]
    sched = ContinuousBatchingEngine(model, params, slots=C["slots"],
                                     max_len=ML, device=device)
    for p, b in reqs[:C["slots"]]:                 # warm: capture the chunk
        sched.submit(p, b)
    sched.run()
    per_chunk = sched.chunk * n_attn
    if sched._loop.graph.launches != {"decode_attention": per_chunk}:
        raise AssertionError(f"the chunk graph holds "
                             f"{sched._loop.graph.launches}")
    zero_launches(ops)
    chunks0, t0 = sched.steps_dispatched, time.perf_counter()
    uids = [sched.submit(p, b) for p, b in reqs]
    res = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    chunks = sched.steps_dispatched - chunks0
    got = {k: v for k, v in ops.LAUNCHES.items() if v}
    want = {"flash_attention": n_attn * len(reqs),
            "decode_attention": chunks * per_chunk}
    toks = sum(len(res[u]) for u in uids)
    log(f"[rsched] {model.cfg.name} ({model.cfg.num_layers} layers), "
        f"{C['slots']} slots, {len(reqs)} "
        f"requests (prompts {C['prompt']}, budgets {C['budget']}): "
        f"{toks} tokens in {wall:.3f}s ({toks / wall:.1f} tok/s), "
        f"{chunks} chunks; launches {got}, expected {want}")
    if got != want or any(len(res[u]) != b for u, (_, b) in zip(uids, reqs)):
        raise AssertionError(f"scheduler launched {got} or cut a request")
    if not compare:
        return
    eng = ServeEngine(model, max_len=ML, device=device)
    for i in range(C["compared"]):
        p, b = reqs[i]
        pt = torch.from_numpy(p).to(device)
        want_t = eng.generate(params, pt, b)[0]
        got_t = torch.from_numpy(res[uids[i]]).to(device)
        if torch.equal(got_t, want_t.to(got_t.dtype)):
            continue
        seq = torch.cat([pt, want_t[None].long()], 1)
        with torch.no_grad():
            lg = model.forward(params, seq)[0][0, p.shape[1] - 1:-1, :V]
        top2 = lg.topk(2, dim=-1).values
        bad = int((got_t != want_t.to(got_t.dtype)).nonzero()[0])
        margin = float(top2[bad, 0] - top2[bad, 1])
        log(f"[rsched] request {i}: differs from B=1 at token {bad}, top-2 "
            f"margin {margin:.3e}")
        if margin >= TF_MARGIN:
            raise AssertionError(f"request {i}: scheduler tokens differ "
                                 "from B=1 greedy above the margin")
    log(f"[rsched] the first {C['compared']} requests: tokens equal their "
        "B=1 ServeEngine greedy tokens (up to a small margin)")


def occupancy_zoo(torch, device) -> None:
    """Phase 1 at the bodies the rest of the zoo launches (bf16): B15's
    tensor-core body with one consumer warpgroup at D=64 (seamless-m4t,
    G=1) and D=128 (llava, G=7), two at D=64 (granite-moe, G=2) and D=128
    (qwen3-moe, G=16); B14 with one q head a block at D=64 (seamless),
    two (granite) and four at D=128 (llava's G=7 in two blocks of four
    slots, one idle; qwen3-moe's G=16 in four): ptxas's registers, spills
    and stack frame, the dynamic shared memory against the 227 KB a block
    may take, and B14's runtime registers, local bytes, blocks an SM and
    grid at the zoo's decode shapes. Fails on a spill, a stack frame, a
    local array or shared memory past the limit."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as kdec
    from repro_torch.kernels import plan as P
    out = _build.BUILD_LOG.get("attention", "")
    lib = _build.load("attention")
    sms = _build.sm_count(device)
    rows = []
    for D, G, who in ((64, 1, "seamless-m4t-medium"),
                      (64, 2, "granite-moe-1b-a400m"),
                      (128, 7, "llava-next-34b"),
                      (128, 16, "qwen3-moe-235b-a22b")):
        wg = P.flash_warpgroups(G, D)
        smem = lib.brds_flash_attention_bf16_smem(D, G)
        if smem != P.flash_smem(G, D):
            raise AssertionError(f"B15's shared memory at D={D}, G={G}: "
                                 f"{smem} != plan's {P.flash_smem(G, D)}")
        rows.append((f"flash_tc_kernelILi{D}ELi{wg}E",
                     f"flash_tc<bf16, {D}, {wg} warpgroup(s)> (B15, {who}, "
                     f"G={G})", smem, ""))
    for D, G, B, Hkv, S, who in ((64, 1, 4, 16, 128, "seamless-m4t-medium "
                                  "self"),
                                 (64, 1, 4, 16, 3072, "seamless-m4t-medium "
                                  "cross"),
                                 (64, 2, 8, 8, 576, "granite-moe-1b-a400m"),
                                 (128, 7, 2, 8, 2976, "llava-next-34b"),
                                 (128, 16, 4, 4, 544, "qwen3-moe-235b-a22b")):
        dp = P.decode_plan(B=B, Hkv=Hkv, G=G, S=S, D=D, elem_bytes=2,
                           sms=sms)
        info = kdec.decode_info(dp, D, G, torch.bfloat16, device)
        if info["local_bytes"]:
            raise AssertionError(f"B14 at {who}: {info}")
        rows.append((f"decode_cluster_kernelI13__nv_bfloat16Li{D}ELi"
                     f"{dp.heads}EE",
                     f"decode_cluster<bf16, {D}, {dp.heads} head(s)> (B14, "
                     f"{who}, G={G})", dp.smem,
                     f"; runtime {info['registers']} registers, "
                     f"{info['local_bytes']} B local, "
                     f"{info['blocks_per_sm']} block(s) an SM, grid "
                     f"{dp.grid} ({dp.groups} head group(s) x {dp.splits} "
                     f"slices x {B * Hkv} (row, kv head) pairs, {S} cache "
                     f"rows): {info['waves']} wave(s)"))
    for frag, name, sm, extra in rows:
        got = ptxas_entry(out, frag)
        if got is None:
            raise AssertionError(f"{name}: not in the build log")
        regs, spill, stack = got
        log(f"[occupancy] {name}: ptxas {regs} registers, {spill} B spill, "
            f"{stack} B stack frame; {sm} B dynamic shared memory (limit "
            f"{P.SMEM_PER_BLOCK}){extra}")
        if spill or stack or sm > P.SMEM_PER_BLOCK:
            raise AssertionError(f"{name}: spills, keeps a stack frame or "
                                 "takes more shared memory than a block may")


def check_attention_zoo(torch, device, flush) -> None:
    """Phase 6 at the shapes the rest of the zoo gives B14 and B15 (ZATTN):
    B15 without a causal mask at seamless-m4t's encoder (B=4, 16 heads of
    64, Sq = Sk = 3072) and cross-attention (Sq = 64 over Sk = 3072); B15
    causal at llava's group of 7 (56 q / 8 kv heads of 128, S = 2944),
    qwen3-moe's group of 16 (64 / 4 of 128, S = 512) and granite-moe's
    (16 / 8 of 64, S = 512); B14 at the same groups over their decode
    caches and over seamless's fixed-length cross memory (every row at
    3072). Each in float32 (ATTN_TOL) and bf16 (one ulp, its floor scaled
    to each output's sum of |p v|: ``attn_held``) against its plain
    version; then each bf16 one timed with L2 flushed beside its plain
    version, ``scaled_dot_product_attention`` (``enable_gqa``) and its
    bound (ZOO_TIMES)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels._build import time_ms
    F = torch.nn.functional
    bf = torch.bfloat16
    for tag, sh in ZATTN["flash"]:
        for dtype in (torch.float32, bf):
            q, k, v = attn_case(torch, device, dtype, B=sh["B"],
                                Hq=sh["Hq"], Hkv=sh["Hkv"], Sq=sh["Sq"],
                                Sk=sh["Sk"], D=sh["D"], seed=sh["Sk"] + 1)
            c = sh["causal"]
            e = attn_held(torch, "flash_attention",
                          ops.flash_attention(q, k, v, causal=c,
                                              backend="cuda"),
                          ops.flash_attention(q, k, v, causal=c,
                                              backend="ref"),
                          f"{tag} {sh} {dtype}",
                          mag=ops.flash_attention(q, k, v.abs(), causal=c,
                                                  backend="ref"),
                          n_keys=sh["Sk"])
            if dtype != bf:
                del q, k, v
                continue
            pairs = sh["B"] * sh["Hq"] * live_pairs(sh["Sq"], sh["Sk"], c)
            run = (lambda: ops.flash_attention(q, k, v, causal=c,
                                               backend="cuda"),
                   lambda: ops.flash_attention(q, k, v, causal=c,
                                               backend="ref"),
                   lambda: F.scaled_dot_product_attention(
                       q, k, v, is_causal=c, enable_gqa=True),
                   bound(nbytes(q, k, v, q), 0,
                         bf16_flops=ATTN_FLOPS * sh["D"] * pairs))
            zoo_time(torch, flush, time_ms, "flash_attention", tag, sh, run,
                     e)
            del q, k, v
    for tag, sh in ZATTN["decode"]:
        for dtype in (torch.float32, bf):
            q, k, v = attn_case(torch, device, dtype, B=sh["B"],
                                Hq=sh["Hq"], Hkv=sh["Hkv"], Sq=1, Sk=sh["S"],
                                D=sh["D"], seed=sh["S"] + 2)
            q = q[:, :, 0]
            L = sh["length"]
            n = torch.full((sh["B"],), L, dtype=torch.int32, device=device)
            e = attn_held(torch, "decode_attention",
                          ops.decode_attention(q, k, v, n, backend="cuda"),
                          ops.decode_attention(q, k, v, n, backend="ref"),
                          f"{tag} {sh} {dtype}",
                          mag=ops.decode_attention(q, k, v.abs(), n,
                                                   backend="ref"),
                          n_keys=L)
            if dtype != bf:
                del q, k, v
                continue
            mask = (torch.arange(sh["S"], device=device)
                    < L)[None, None, None, :]
            live = sh["B"] * sh["Hkv"] * L * sh["D"] * 2
            run = (lambda: ops.decode_attention(q, k, v, n, backend="cuda"),
                   lambda: ops.decode_attention(q, k, v, n, backend="ref"),
                   lambda: F.scaled_dot_product_attention(
                       q[:, :, None], k, v, attn_mask=mask, enable_gqa=True),
                   bound(nbytes(q) * 2 + live * 2, 0,
                         bf16_flops=ATTN_FLOPS * sh["B"] * sh["Hq"] * L
                         * sh["D"]))
            zoo_time(torch, flush, time_ms, "decode_attention", tag, sh, run,
                     e)
            del q, k, v


def zoo_time(torch, flush, time_ms, name, tag, sh, run, err) -> None:
    kern, plain, lib, (bms, by) = run
    ms, pms, lms = (time_ms(f, flush) for f in (kern, plain, lib))
    ZOO_TIMES.append(dict(name=name, shape=tag, ms=ms, plain_ms=pms,
                          library_ms=lms, bound_ms=bms, bound_by=by,
                          max_abs_err=err))
    log(f"[time] {name:16} {tag} {sh}: kernel {ms:.4f} ms, plain "
        f"{pms:.4f} ms, library (SDPA) {lms:.4f} ms, bound {bms * 1e3:.2f} "
        f"us ({by}) — median of 30, L2 flushed, bf16")


def int8_rel(torch, cfg, params, tokens, ML) -> float:
    """max |bf16-cache logits - int8-cache logits| / max |bf16-cache
    logits| of the first decode step (the prefill's greedy token) after
    the same prompt's prefill, ``cfg`` with and without ``kv_quant`` on
    the same params (the prefill logits equal: it attends the unquantized
    k and v)."""
    from repro_torch.models import build_model
    V = cfg.vocab_size
    logits = []
    for q in (False, True):
        m = build_model(cfg.with_(kv_quant=q))
        lp, c = m.prefill(params, tokens, ML)
        t = lp[:, :, :V].argmax(-1)
        lg, _ = m.decode_step(params, c, t, tokens.shape[1])
        logits.append((lp, lg[..., :V].float()))
        del c
    if not torch.equal(logits[0][0], logits[1][0]):
        raise AssertionError("the int8 cache's prefill logits differ from "
                             "the bf16 cache's")
    (_, lb), (_, lq) = logits
    return ((lb - lq).abs().max() / lb.abs().max()).item()


def fan_in_qk(params):
    """``params`` with every attention's ``wq`` and ``wk`` (cross-attention's
    too) rescaled to the standard fan-in scale, a standard deviation of
    1/sqrt(d_model): the reference's init takes the head count as the
    fan-in of these (d, heads, head_dim) weights (``layers._default_scale``:
    the second-to-last dim), which gives full-width q and k entries of std
    ~8-20 and attention scores of std ~64-221, a one-hot softmax."""
    def fix(a):
        d = a["wq"].shape[0]
        return dict(a, wq=a["wq"] * math.sqrt(a["wq"].shape[1] / d),
                    wk=a["wk"] * math.sqrt(a["wk"].shape[1] / d))
    out = dict(params)
    for key in ("layers", "enc_blocks", "dec_blocks"):
        if key in params:
            out[key] = [dict(blk, **{n: fix(blk[n]) for n in ("attn", "xattn")
                                     if n in blk}) for blk in params[key]]
    return out


def expected_launches(model, G: int) -> dict:
    """B15 a prefill and B14 over a G-step decode of ``model``: one each a
    decoder attention layer; an encoder-decoder's encoder layers add a
    B15 each, its cross-attention a B15 and a B14 each a decoder layer."""
    if hasattr(model, "kinds"):
        n = sum(k.startswith("attn") for k in model.kinds)
        return {"flash_attention": n, "decode_attention": n * G}
    return {"flash_attention": model.n_enc + 2 * model.n_dec,
            "decode_attention": 2 * model.n_dec * G}


def zoo_serve(torch, device) -> None:
    """Phase 11: the rest of the zoo at full width in bf16 through
    ``ServeEngine``, greedy, each model freed before the next; weights from
    a seeded CUDA generator (seed 0), prompts from a CPU generator (seed
    1), frames and patches from one (seed 2). Cuts (ZSERVE): qwen3-moe-
    235b-a22b to 4 of its 94 layers (the whole model is 470 GB of bf16
    weights; 4 layers at full width are 22.4 GB), llava-next-34b to 6 of
    60 (70.5 GB of weights leave too little of 80 GB for the plain path's
    comparison), granite-moe-1b-a400m to 6 of 24 and llama3.2-3b (the
    int8 KV cache) to 6 of 28 (to leave phase 13 room in the time limit);
    seamless-m4t-medium at full depth.

    For each: the launch counts set to 0 just before one generate and read
    just after (B15 a prefill and B14 a step, ``expected_launches``, every
    B15 on the tensor-core body); the captured decode loop bitwise the
    host loop; the wall a decode step, the prefill, the busy share of a
    ZBUSY_GEN-step generate and the peak memory of one generate; every
    B14 / B15 launch of a teacher-forced run within one bf16 ulp of its
    largest output of its plain version on the model's own inputs
    (``held_calls``); and the plain path's own one-ulp spread (printed).

    The reference's init takes the head count as the fan-in of the
    (d, heads, head_dim) q and k projections: at full width their
    attention scores have a standard deviation of ~64 (seamless-m4t,
    granite-moe) to ~221 (llama3.2-3b), the softmax is one-hot, and one
    bf16 ulp on half the embedding moves the plain path's own logits by
    as much as the logits themselves at full depth (printed). Kernels
    that round otherwise than the plain versions cannot keep such a
    model's tokens, so the end-to-end logit and token gates
    (``hold_to_plain``: logits within TF_LOGIT_TOL, tokens up to a top-2
    margin below TF_MARGIN) run at full depth on the same model with
    ``wq`` and ``wk`` at the standard fan-in scale (``fan_in_qk``: scores
    of std ~1, as a trained model's), where that spread is 0.03-0.06
    (printed); qwen3-moe, whose qk-norm keeps its scores near std 1, on
    its own weights (``fan_in=False``). granite-moe (``scheduler``,
    ``draft``) also under the scheduler on those weights (RSCHED, its
    launches held, four requests equal to B=1 up to a small margin) and
    as the target of a packed lstm_ptb draft rebound to its vocabulary
    (k=4; its prompt primed by B12), tokens equal to target-only.
    llama3.2-3b with ``kv_quant``: the int8-cache decode step's logits
    within INT8_GATE (relative) of the bf16 cache's on the same prompt,
    the gate at the fan-in scale; printed beside it, the same at the
    reference's init and both on the plain path (``use_backend("ref")``),
    which shows whether a reading past the gate belongs to the init or
    to the kernels."""
    import gc
    for arch, R in ZSERVE.items():
        t0 = time.perf_counter()
        zoo_one(torch, device, arch, R)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[zserve] {arch}: {time.perf_counter() - t0:.1f}s")


def zoo_one(torch, device, arch, R) -> None:
    import dataclasses
    import gc
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops
    from repro_torch.models import LSTMModel, LSTM_CONFIGS, build_model
    from repro_torch.serving import ServeEngine, runtime
    from repro_torch.sparse import lstm_policy, use_backend
    from repro_torch.spec import DraftModel
    laps, t_lap = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        laps[name] = round(now - t_lap[0], 1)
        t_lap[0] = now
    full = get_arch(arch)
    cfg = full.with_(num_layers=R.get("layers", full.num_layers),
                     kv_quant=R.get("kv_quant", False))
    B, P, G = R["batch"], R["prompt"], R["gen"]
    ML = P + G
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device).manual_seed(0), device)
    torch.cuda.synchronize()
    V, d = cfg.vocab_size, cfg.d_model
    tokens = torch.randint(0, V, (B, P), generator=torch.Generator()
                           .manual_seed(1)).to(device)
    rows = R.get("frames") if cfg.encdec else cfg.num_patches
    extra = None
    if rows:
        extra = torch.randn((B, rows, d), generator=torch.Generator()
                            .manual_seed(2)).to(device, cfg.torch_dtype)
    cache_bytes = sum(math.prod(x.shape) * x.dtype.itemsize
                      for x in runtime.leaves(model.cache_defs(B, ML)))
    log(f"[zserve] {arch}: {cfg.num_layers} of {full.num_layers} layers"
        + (f" (+{model.n_enc} encoder)" if cfg.encdec else "")
        + f", d={d} heads {cfg.num_heads}/{cfg.num_kv_heads}x{cfg.head_dim}"
        + (f" (q stored as {cfg.pad_heads_to})" if cfg.pad_heads_to else "")
        + (f", {cfg.num_experts} experts top-{cfg.experts_per_token} of "
           f"ff {cfg.d_ff}" if cfg.moe else f", ff {cfg.d_ff}")
        + f", V={V} {cfg.dtype}"
        + (", int8 KV cache" if cfg.kv_quant else "")
        + f": {model.param_count() / 1e9:.3f} B params "
        f"({model.param_count() * 2 / 1e9:.2f} GB), init "
        f"{time.perf_counter() - t0:.2f}s (CUDA generator, seed 0); B={B}, "
        f"prompt {P}" + (f" ({rows} {'frames' if cfg.encdec else 'patches'}"
                         ")" if rows else "")
        + f", gen {G}; decode cache {cache_bytes / 1e6:.1f} MB")
    eng = ServeEngine(model, max_len=ML, device=device)

    def gen(n=G, e=eng, p=params, **kw):
        return e.generate(p, tokens, n, extra=extra, **kw)
    gen(2)                                  # warm the libraries
    gen(G)                                  # captures the G graph
    torch.cuda.synchronize()
    zero_launches(ops)
    for k in kfa.BODIES:
        kfa.BODIES[k] = 0
    out = gen()
    torch.cuda.synchronize()
    got = {k: n for k, n in ops.LAUNCHES.items() if n}
    want = expected_launches(model, G)
    log(f"[zserve] {arch} greedy: launches {got}, expected {want}; B15 by "
        f"body {kfa.BODIES}")
    if got != want or kfa.BODIES != {"tensor_cores":
                                     want["flash_attention"], "simt": 0}:
        raise AssertionError(f"{arch} launched {got} ({kfa.BODIES}), "
                             f"expected {want}, every B15 on the tensor "
                             "cores")
    if out.shape != (B, G) or not bool(((out >= 0) & (out < V)).all()):
        raise AssertionError(f"{arch}: bad tokens {tuple(out.shape)}")
    lap("captures, counted generate")
    kw = {} if extra is None else {"extra": extra}
    dts = timed_runs(torch, gen, ZRUNS)
    pre = timed_runs(torch, lambda: model.prefill(params, tokens, ML, **kw),
                     ZRUNS)
    med, pm = statistics.median(dts), statistics.median(pre)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    _, state = gen(return_state=True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    hts = []
    h_out, h_state = timed_call(torch, hts, lambda: host_loop(
        eng, params, tokens, G, extra))
    if not (torch.equal(out, h_out) and all(
            torch.equal(a, b) for a, b in zip(runtime.leaves(state),
                                              runtime.leaves(h_state)))):
        raise AssertionError(f"{arch}: the captured decode loop differs "
                             "from the host loop")
    del state, h_state, h_out
    lap("timed runs, host loop")
    gen(ZBUSY_GEN)                          # captures its graph
    bw = statistics.median(timed_runs(torch, lambda: gen(ZBUSY_GEN), ZRUNS))
    busy, span, _ = device_busy(torch, lambda: gen(ZBUSY_GEN),
                                host_ops=False)
    row = {"path": f"{arch}", "batch": B, "prefill_ms": pm * 1e3,
           "captured_wall": (med - pm) / G,
           "host_wall": (hts[0] - pm) / G, "busy_share": busy / bw}
    GRAPH_ROWS.append(row)
    log(f"[zserve] {arch}: generate median {med:.4f}s of {ZRUNS} "
        f"({B * G / med:.1f} tok/s, prefill included); prefill "
        f"{pm * 1e3:.2f} ms ({B * P / pm:.1f} prompt tok/s); wall / decode "
        f"step (generate minus prefill, over {G}) captured "
        f"{row['captured_wall'] * 1e3:.3f} ms, host loop "
        f"{row['host_wall'] * 1e3:.3f} ms; a {ZBUSY_GEN}-step generate "
        f"(prefill included): wall {bw * 1e3:.2f} ms, device busy "
        f"{busy * 1e3:.2f} ms (span {span * 1e3:.2f}) = {busy / bw:.1%}; "
        f"peak allocated during one generate {peak / 1e9:.3f} GB "
        f"({(peak - before) / 1e9:+.3f} GB over the {before / 1e9:.3f} GB "
        "before it); tokens and state bitwise the host loop")
    lap("busy share")
    calls, err, scale = held_calls(torch, lambda: tf_logits(
        torch, model, params, tokens, out, ML, extra))
    hwant = want["flash_attention"] + want["decode_attention"] // G * (G - 1)
    log(f"[zserve] {arch}: all {calls} B14 / B15 launches of the "
        f"teacher-forced run (prefill + {G - 1} steps) within one bf16 ulp "
        f"of their largest output of their plain versions on the same "
        f"inputs (max |err| {err:.3e}, max |output| {scale:.3e})")
    if calls != hwant:
        raise AssertionError(f"{calls} attention calls held, expected "
                             f"{hwant}")
    lap("held launches")
    with use_backend("ref"):
        lr, _ = model.prefill(params, tokens, ML, **kw)
    lk, _ = model.prefill(params, tokens, ML, **kw)
    gap = (lk - lr)[..., :V].abs().max().item()
    spread = one_ulp_spread(torch, model, params, tokens, ML, lr, extra)
    log(f"[zserve] {arch} ({cfg.num_layers} layers) prefill logits: kernels "
        f"vs plain {gap:.3e}; the plain path itself moves {spread:.3e} when "
        "half the embedding's entries move one bf16 ulp (max|logit| "
        f"{lr[..., :V].abs().max().item():.2f})")
    del lr, lk
    lap("one-ulp spread")
    # the end-to-end gates, on the same model with q and k at the standard
    # fan-in scale (fan_in_qk), where one ulp does not decorrelate it, or
    # on its own weights where R says fan_in=False
    fparams = params
    if R.get("fan_in", True):
        fparams = fan_in_qk(params)
        with use_backend("ref"):
            lr, _ = model.prefill(fparams, tokens, ML, **kw)
        fspread = one_ulp_spread(torch, model, fparams, tokens, ML, lr,
                                 extra)
        log(f"[zserve] {arch} with q and k at the fan-in scale: the plain "
            f"path's one-ulp spread {fspread:.3e} (max|logit| "
            f"{lr[..., :V].abs().max().item():.2f})")
        del lr
    fout = gen(p=fparams)
    hold_to_plain(torch, "zserve", eng, fparams, tokens, fout, extra)
    lap("end-to-end gates")
    if cfg.kv_quant:
        # the same weights with the cache in bf16: the first decode step's
        # logits from the same prompt's prefill, at the reference's init
        # (printed) and at the fan-in scale (the gate), each on the kernel
        # path and on the plain path (printed)
        rel = int8_rel(torch, cfg, params, tokens, ML)
        frel = int8_rel(torch, cfg, fparams, tokens, ML)
        with use_backend("ref"):
            prel = int8_rel(torch, cfg, params, tokens, ML)
            pfrel = int8_rel(torch, cfg, fparams, tokens, ML)
        bcache = sum(math.prod(x.shape) * x.dtype.itemsize
                     for x in runtime.leaves(build_model(cfg.with_(
                         kv_quant=False)).cache_defs(B, ML)))
        log(f"[zserve] {arch} int8 KV cache ({cache_bytes / 1e6:.1f} MB "
            f"against {bcache / 1e6:.1f} MB in bf16): the first decode "
            f"step's logits {frel:.4f} of max|logit| from the bf16 cache's "
            f"(gate {INT8_GATE}); {rel:.4f} at the reference's init; the "
            f"plain path (use_backend('ref')) reads {pfrel:.4f} and "
            f"{prel:.4f}")
        if not 0 < frel < INT8_GATE:
            raise AssertionError(f"int8 KV decode {frel:.4f} from bf16")
        lap("int8 vs bf16 cache")
    if R.get("scheduler"):
        zoo_scheduler(torch, device, model, fparams, compare=True)
        lap("scheduler")
    del fparams, fout
    if R.get("draft"):
        dcfg = dataclasses.replace(LSTM_CONFIGS["lstm_ptb"],
                                   vocab_size=model.vocab_padded)
        deng = ServeEngine(LSTMModel(dcfg), max_len=ML, device=device,
                           sparsity=lstm_policy(0.75, 0.5))
        dparams, _ = deng.prepare(deng.model.init(
            torch.Generator().manual_seed(7), device))
        draft = DraftModel(deng.model, dparams, scan_prefill=True)
        gen(draft=draft, spec_k=SPEC_K)     # captures the spec chunks
        zero_launches(ops)
        sdt = []
        sout, st = timed_call(torch, sdt, lambda: gen(
            draft=draft, spec_k=SPEC_K, return_state=True))
        sgot = {k: v for k, v in ops.LAUNCHES.items() if v}
        ran = st["chunks"] * eng.spec_rounds
        swant = {"fused_brds_lstm_scan": dcfg.num_layers,
                 "fused_brds_lstm_step": dcfg.num_layers * (SPEC_K + 1) * ran,
                 "flash_attention": want["flash_attention"],
                 "decode_attention": want["decode_attention"] // G
                 * (SPEC_K + 1) * ran}
        if sgot != swant:
            raise AssertionError(f"{arch} spec launched {sgot}, expected "
                                 f"{swant}")
        same_tokens(torch, f"{arch} spec (lstm_ptb draft, V="
                    f"{dcfg.vocab_size}) vs target-only greedy", sout, out)
        acc, drafted = int(st["accepted"].sum()), int(st["drafted"].sum())
        log(f"[zserve] {arch} spec k={SPEC_K}: launches {sgot}; acceptance "
            f"{acc / max(drafted, 1):.4f} ({acc}/{drafted}), "
            f"{int(st['rounds'].max())} rounds, {sdt[0]:.4f}s "
            f"({B * G / sdt[0]:.1f} tok/s)")
        del deng, dparams, draft, st, sout
        lap("spec")
    del eng, params, model, out
    gc.collect()
    log(f"[zserve] {arch} by part {laps}")


def serve_inputs(torch, cfg, device):
    """Phase 3's full-width inputs: seed-0 weights, the B=8 prompt (seed
    1) and the calibration batch (seed 3)."""
    from repro_torch.models import LSTMModel
    B, P = SERVE["batch"], SERVE["prompt"]
    params = LSTMModel(cfg).init(torch.Generator().manual_seed(0), device)
    draw = lambda shape, seed: torch.randint(
        0, cfg.vocab_size, shape,
        generator=torch.Generator().manual_seed(seed)).to(device)
    return params, draw((B, P), 1), draw((B, min(P, 32)), 3)


def dist_paths() -> dict:
    """Phase 12's packed paths: tag → (policy rules, the dual-SpMV kernel
    its chained step launches before lstm_gates)."""
    from repro_torch.sparse import DeltaGateConfig, QuantConfig
    return {"float": ({}, "rb_dual_spmv"),
            "delta0": (dict(delta=DeltaGateConfig()), "delta_rb_dual_spmv"),
            "delta0.05": (dict(delta=DeltaGateConfig(theta_x=0.05,
                                                     theta_h=0.05)),
                          "delta_rb_dual_spmv"),
            "int8": (dict(quant=QuantConfig("int8")), "rb_dual_parts_q8"),
            "delta0+int8": (dict(delta=DeltaGateConfig(),
                                 quant=QuantConfig("int8")),
                            "rb_dual_parts_q8")}


def dist_rank(mesh, spawned: float) -> dict:
    """Phase 12 on one rank: full-width lstm_ptb through
    ``ServeEngine(mesh=)`` on every path of ``dist_paths``: ``DRUNS``
    timed generates, the first with the launch counts set to 0 just before
    and read just after (the median discards its first-call costs), and
    the collective inventory of one decode step. Returns the tokens,
    logits, counts, inventory, the median wall a step and where the rank's
    time went (``spawned``: the parent's clock when it started the
    ranks)."""
    faulthandler.enable(all_threads=True)
    import torch
    import torch.distributed as dist
    from repro_torch.dist.collective_ops import batch_rows
    from repro_torch.kernels import ops
    from repro_torch.models import LSTMModel, LSTM_CONFIGS
    from repro_torch.obs import collectives
    from repro_torch.serving import ServeEngine
    from repro_torch.sparse import lstm_policy
    device = torch.device("cuda", torch.cuda.current_device())
    cfg = LSTM_CONFIGS["lstm_ptb"]
    B, P, G = SERVE["batch"], SERVE["prompt"], SERVE["gen"]
    laps = {"start": time.time() - spawned}
    t0 = time.perf_counter()
    params, tokens, calib = serve_inputs(torch, cfg, device)
    laps["weights"] = time.perf_counter() - t0
    rows = batch_rows(mesh, B)
    out = {"rank": dist.get_rank(), "rows": (rows.start, rows.stop),
           "laps": laps}
    for tag, (rules, _) in dist_paths().items():
        t0 = time.perf_counter()
        eng = ServeEngine(LSTMModel(cfg), max_len=P + G,
                          sparsity=lstm_policy(0.75, 0.5, **rules),
                          device=device, mesh=mesh)
        packed, _ = eng.prepare(params,
                                calib=calib if "quant" in rules else None)
        if not eng._dist or eng.model._use_fused:
            raise AssertionError(f"{tag}: the engine did not take the "
                                 "sharded chained path")
        torch.cuda.synchronize()
        laps[f"{tag} prepare"] = time.perf_counter() - t0
        walls = []
        for i in range(DRUNS):
            torch.cuda.synchronize()
            dist.barrier()
            if i == 0:
                zero_launches(ops)
            t0 = time.perf_counter()
            toks, st = eng.generate(packed, tokens, G, return_state=True)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if i == 0:
                launches = {k: n for k, n in ops.LAUNCHES.items() if n}
                keep = (toks.cpu().numpy(), st["logits"].float().cpu().numpy())
        laps[f"{tag} generates"] = sum(walls)
        inv = collectives.summarize_inventory(
            collectives.decode_step_inventory(
                eng.model, packed, st["cache"],
                toks[rows, -1:].long(), P + G))
        out[tag] = dict(toks=keep[0], logits=keep[1], launches=launches,
                        inventory=inv,
                        step_ms=statistics.median(walls) / (P + G) * 1e3)
        del eng, packed, st
    return out


def shard_times(torch, device, flush) -> None:
    """B1, B4, B7 and B2 alone on each shard's gate-aligned rows, held
    against the same rows of the unsharded launch (bitwise, or the finding
    printed and held to Z_TOL / CELL_TOL), and timed beside it with L2
    flushed: at a model axis of 2 (the 4-rank mesh's shard, its data
    group's B/2 rows) and 4 (375 hidden units a shard), B=8."""
    from repro_torch.dist.partition import gate_row_permutation
    from repro_torch.dist.partition import permute_packed_rows as rows_of
    from repro_torch.kernels import ops
    from repro_torch.kernels import rb_spmv_q8 as kq8
    from repro_torch.kernels._build import time_ms
    for n in DSHARDS:
        B = SERVE["batch"] // (2 if n == 2 else 1)
        cs = make_case(torch, device, B=B, X=1500, H=1500, spar_x=0.75,
                       spar_h=0.5, seed=1)
        H = cs["H"]
        (qx, sax, qh, sah), (fx, fh) = q8_acts(cs, "int8"), cs["fired"][1.0]
        qsx, qsh = cs["q8"]["int8"]
        perm = gate_row_permutation(H, n)

        def block(j):
            return perm[j * 4 * H // n:(j + 1) * 4 * H // n]

        def kernels(j):
            """(name → launch) of shard j's rows (None: unsharded)."""
            sx, sh, b, m, c = (cs[k] for k in ("sx", "sh", "bias", "m", "c"))
            qx8, qh8 = qsx, qsh
            if j is not None:
                blk = torch.as_tensor(block(j), device=device)
                sx, sh = rows_of(sx, block(j)), rows_of(sh, block(j))
                qx8, qh8 = rows_of(qsx, block(j)), rows_of(qsh, block(j))
                b, m = b[blk], m[:, blk]
                c = c[:, j * H // n:(j + 1) * H // n].contiguous()
            z = ops.rb_dual_spmv(sx, cs["x"], sh, cs["h"], b, backend="cuda")
            h4 = z.shape[1] // 4
            zs = [z[:, i * h4:(i + 1) * h4] for i in range(4)]
            return {
                "rb_dual_spmv": lambda: ops.rb_dual_spmv(
                    sx, cs["x"], sh, cs["h"], b, backend="cuda"),
                "delta_rb_dual_spmv": lambda: ops.delta_rb_dual_spmv(
                    sx, cs["dx"], fx, sh, cs["dh"], fh, m, backend="cuda"),
                # these two return (zx, zh) and (c, h): concatenated only
                # to compare, outside the timed call
                "rb_dual_parts_q8": lambda: kq8.rb_dual_parts_q8(
                    qx8.values, qx8.deltas, qx8.scales * sax, qx, qh8.values,
                    qh8.deltas, qh8.scales * sah, qh, qx8.rows),
                "lstm_gates": lambda: ops.lstm_gates(*zs, c,
                                                     backend="cuda")}

        def out(run):
            got = run()
            return torch.cat(got, 1) if isinstance(got, tuple) else got

        full = kernels(None)
        shards = [kernels(j) for j in range(n)]
        for name, run in full.items():
            whole = out(run)
            tol = CELL_TOL if name == "lstm_gates" else Z_TOL
            diffs = []
            for j, ks in enumerate(shards):
                got = out(ks[name])
                blk = torch.as_tensor(block(j), device=device)
                if name == "lstm_gates":        # (c, h) of the shard's units
                    cols = torch.cat([torch.arange(j * H // n,
                                                   (j + 1) * H // n) + k * H
                                      for k in range(2)]).to(device)
                elif name == "rb_dual_parts_q8":    # (zx, zh) of its rows
                    cols = torch.cat([blk, blk + 4 * H])
                else:
                    cols = blk
                diffs.append((got - whole[:, cols]).abs().max().item())
            worst = max(diffs)
            if worst > tol:
                raise AssertionError(f"{name} at {n} shards: shard rows "
                                     f"differ from the unsharded launch's "
                                     f"by {worst:.3e} > {tol:.0e}")
            ms = [time_ms(ks[name], flush) for ks in shards]
            log(f"[dist] {name:19} B={B} {n} shards ({4 * H // n} rows, "
                f"{H // n} units each): "
                + ("bitwise the unsharded launch's rows" if worst == 0 else
                   f"FINDING: not bitwise the unsharded launch's rows, max "
                   f"|diff| {worst:.3e} (held to {tol:.0e})")
                + f"; shard ms {', '.join(f'{t:.4f}' for t in ms)} (max / "
                f"min {max(ms) / min(ms):.3f}), unsharded "
                f"{time_ms(run, flush):.4f} ms — median of 30, L2 flushed")


def dist_serve(torch, device) -> None:
    """Phase 12: sharded decode over ``DMESHES`` (``dist_rank`` on spawned
    gloo ranks, all on this card), every rank's tokens and logits held
    against the single-device chained path on the card (bitwise, or the
    finding printed and held to LOGIT_TOL and the margins), its launch
    counts to (prompt + gen) x layers of the path's dual SpMV and of
    lstm_gates, and its inventory to one all-gather of the rank's h slice
    a layer a step; then the shard kernel times (``shard_times``)."""
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import LSTMModel, LSTM_CONFIGS
    from repro_torch.serving import ServeEngine
    from repro_torch.sparse import lstm_policy
    cfg = LSTM_CONFIGS["lstm_ptb"]
    B, P, G = SERVE["batch"], SERVE["prompt"], SERVE["gen"]
    want = (P + G) * cfg.num_layers
    torch.cuda.empty_cache()
    log("[dist] gloo on this one card: NCCL refuses two ranks on one card, "
        "so every all-gather is staged through host memory (walls below are "
        "gloo host-staged, not a measure of NCCL)")
    runs = {}
    for mesh in DMESHES:
        t0 = time.perf_counter()
        runs[mesh] = run_ranks(dist_rank, *mesh, device="cuda",
                               backend="gloo", args=(time.time(),),
                               threads=2, timeout=300)
        log(f"[dist] mesh data={mesh[0]} model={mesh[1]}: "
            f"{mesh[0] * mesh[1]} ranks in {time.perf_counter() - t0:.1f}s; "
            "rank 0's seconds: " + ", ".join(
                f"{k} {v:.2f}" for k, v in runs[mesh][0]["laps"].items()))
    params, tokens, calib = serve_inputs(torch, cfg, device)
    for tag, (rules, b1) in dist_paths().items():
        eng = ServeEngine(LSTMModel(cfg, fused=False), max_len=P + G,
                          sparsity=lstm_policy(0.75, 0.5, **rules),
                          device=device)
        packed, _ = eng.prepare(params,
                                calib=calib if "quant" in rules else None)
        ref = {}
        for d in sorted({m[0] for m in DMESHES}):
            per = B // d
            for r in range(d):
                t, st = eng.generate(packed, tokens[r * per:(r + 1) * per], G,
                                     return_state=True)
                ref[(d, r * per)] = (t.cpu(), st["logits"].float().cpu())
        for (d, m), ranks in runs.items():
            per = B // d
            bitwise = True
            for rk in ranks:
                got = rk[tag]
                lo, hi = rk["rows"]
                wt, wl = ref[(d, lo)]
                gt = torch.as_tensor(got["toks"])
                gl = torch.as_tensor(got["logits"])
                if gt.shape != (B, G):
                    raise AssertionError(f"[dist] {tag}: tokens "
                                         f"{tuple(gt.shape)}")
                if not (torch.equal(gt[lo:hi], wt)
                        and torch.equal(gl[lo:hi], wl)):
                    # the finding: held to the serve gates instead
                    bitwise = False
                    e = (gl[lo:hi] - wl).abs().max().item()
                    log(f"[dist] FINDING {tag} mesh {d},{m} rank "
                        f"{rk['rank']}: not bitwise the single-device "
                        f"chained path; max |last logit diff| {e:.3e} "
                        f"(held to {LOGIT_TOL:.0e}, tokens equal)")
                    if not e <= LOGIT_TOL:
                        raise AssertionError(f"{tag}: logits {e:.3e} > "
                                             f"{LOGIT_TOL:.0e}")
                    same_tokens(torch, f"{tag} mesh {d},{m}", gt[lo:hi], wt)
                exp = {b1: want, "lstm_gates": want}
                if got["launches"] != exp:
                    raise AssertionError(f"{tag} mesh {d},{m} rank "
                                         f"{rk['rank']} launched "
                                         f"{got['launches']}, expected {exp}")
                inv = got["inventory"]
                wire = cfg.num_layers * per * (cfg.hidden // m) * 4
                if inv["counts"] != {"all-gather": cfg.num_layers} or \
                        inv["wire_bytes"] != wire:
                    raise AssertionError(f"{tag} mesh {d},{m}: a decode "
                                         f"step's collectives {inv}, "
                                         f"expected {cfg.num_layers} "
                                         f"all-gather of {wire} bytes")
            log(f"[dist] {tag} mesh data={d} model={m}: tokens and logits "
                + ("bitwise" if bitwise else "held to the gates")
                + " the single-device chained path's on every rank; "
                f"launches a rank {ranks[0][tag]['launches']}; a decode "
                f"step's collectives {ranks[0][tag]['inventory']}; wall a "
                "step (gloo host-staged) "
                + ", ".join(f"rank {rk['rank']} {rk[tag]['step_ms']:.3f} ms"
                            for rk in ranks))
        del eng, packed
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    shard_times(torch, device, flush)
    del flush


def piece_of(full, placements, coords: dict, sizes: dict):
    """The piece of ``full`` that the rank at mesh ``coords`` holds under
    ``placements`` (DTensor's layout, the mesh dims in order)."""
    out = full
    for axis, pl in zip(sizes, placements):
        if pl.is_shard():
            n = out.shape[pl.dim] // sizes[axis]
            out = out.narrow(pl.dim, coords[axis] * n, n)
    return out


def digest(t) -> str:
    """sha256 of a tensor's bytes (its local piece for a DTensor)."""
    import hashlib
    import torch
    t = t.to_local() if hasattr(t, "to_local") else t
    return hashlib.sha256(t.detach().reshape(-1).contiguous().cpu()
                          .view(torch.uint8).numpy()).hexdigest()


def split_inputs(torch, device):
    """Phase 13's qwen3-0.6b: the config, seed-0 weights from a CUDA
    generator on this card (the same in every rank) and the prompt."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    cfg = get_arch(SPLIT["arch"])
    model = build_model(cfg)
    params = model.init(torch.Generator(device).manual_seed(0), device)
    tokens = torch.randint(0, cfg.vocab_size, (SPLIT["batch"],
                                               SPLIT["prompt"]),
                           generator=torch.Generator().manual_seed(1)
                           ).to(device)
    return cfg, model, params, tokens


def lstm13_inputs(torch, device):
    """Phase 13's lstm_ptb: the model, seed-0 weights, the corpus and its
    first batch (B=16, T=35), on ``device``."""
    from repro_torch.launch import pipeline as pl
    from repro_torch.models import LSTMModel, LSTM_CONFIGS
    from repro_torch.training.data import ZipfInduction
    cfg = LSTM_CONFIGS["lstm_ptb"]
    model = LSTMModel(cfg)
    params = model.init(torch.Generator().manual_seed(0), device)
    corpus = ZipfInduction(vocab_size=cfg.vocab_size)
    batch = pl._as_model_batch(corpus.batch(0, TRAIN["batch"],
                                            TRAIN["seq"]), device)
    pcfg = pl.PipelineConfig(batch=TRAIN["batch"], seq_len=TRAIN["seq"],
                             device=str(device))
    return model, params, corpus, batch, pcfg


def step_memory(torch, step_fn, p, o, batch, step):
    """(bytes of the params and optimizer state held: a rank's pieces;
    the peak a step allocates above what was live before it; the step's
    (params, state)) on this card."""
    from repro_torch.training.tree import leaves
    held = sum((x.to_local() if hasattr(x, "to_local") else x).nbytes
               for x in leaves((p, o)))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    p, o, _ = step_fn(p, o, batch, step)
    torch.cuda.synchronize()
    return held, torch.cuda.max_memory_allocated() - base, (p, o)


def shard13_rank(mesh, spawned: float, ckpt_dir: str, single_toks) -> dict:
    """Phase 13 on one rank (see ``sharded_phase``): the sharded train
    step against this card's one-device step, ``train_lstm(mesh=)``,
    masked steps, compression card vs CPU, the checkpoint written on
    (2, 2) or restored onto (1, 2), and qwen3-0.6b's split-KV decode."""
    faulthandler.enable(all_threads=True)
    import types
    import torch
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.dist.collective_ops import shard_local
    from repro_torch.launch import pipeline as pl
    from repro_torch.obs.collectives import inventory
    from repro_torch.sparse import lstm_policy
    from repro_torch.training import (CheckpointManager, OptConfig,
                                      compression, elastic_restore,
                                      init_state, jit_train_step)
    from repro_torch.training.train_loop import (opt_shardings,
                                                 param_shardings,
                                                 value_and_grad)
    from repro_torch.training.tree import leaves
    device = torch.device("cuda", torch.cuda.current_device())
    shape = tuple(mesh.shape)
    names = tuple(mesh.mesh_dim_names)
    laps = {"start": time.time() - spawned}
    t_lap = [time.perf_counter()]

    def lap(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        laps[name] = round(now - t_lap[0], 2)
        t_lap[0] = now
    out = {"rank": dist.get_rank(), "laps": laps,
           "coords": {a: mesh.get_local_rank(a) for a in names}}
    model, params, corpus, batch, pcfg = lstm13_inputs(torch, device)
    arch = types.SimpleNamespace(grad_accum=1, zero1=True)
    oc = OptConfig(lr=TRAIN["lr"], warmup_steps=1, total_steps=10)
    step = jit_train_step(mesh, model, arch, oc, batch)
    p_sh = param_shardings(mesh, model)
    o_sh = opt_shardings(mesh, oc, p_sh, model.param_defs())
    lap("init")
    with FlopCounterMode(display=False) as fl:
        loss, grads = step.grads(params, batch)
    lap("sharded grads")
    with FlopCounterMode(display=False) as fl1:
        loss1, grads1 = value_and_grad(model.loss, params, batch)
    rel = max((g.to_local().float() - shard_local(w, mesh, sh.placements)
               .float()).abs().max().item() / max(w.abs().max().item(),
                                                   1e-30)
              for g, w, sh in zip(leaves(grads), leaves(grads1),
                                  leaves(p_sh)))
    del grads1
    lap("one-device grads")
    p, o = params, init_state(oc, params)
    walls = []
    for i in range(2):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        p, o, met = step(p, o, batch, 1 + i)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    held, peak, (p, o) = step_memory(torch, step, p, o, batch, 3)
    # phase 14's references: a whole step's aten FLOPs, and a second
    # step's collectives under torch.profiler (apart: a dispatch mode
    # under the profiler records each c10d op twice)
    with FlopCounterMode(display=False) as fls:
        p, o, _ = step(p, o, batch, 4)
    inv = inventory(step, p, o, batch, 5)
    dry = dict(flops=fls.get_total_flops(), held=held, peak=peak,
               batch=sum(v.nbytes for v in batch.values()),
               colls=[(it["kind"], it["bytes"]) for it in inv])
    out["train"] = dict(loss=float(loss), loss1=float(loss1), grad_rel=rel,
                        step_s=walls, step_loss=float(met["loss"]),
                        pieces=[digest(x) for x in leaves(p)],
                        flops=(fl.get_total_flops(), fl1.get_total_flops()),
                        mem=(held, peak), dry=dry)
    del p, o, grads
    lap("two dense steps")
    losses = []
    pl.train_lstm(model, corpus, pcfg, steps=SHARD13["steps"],
                  lr=TRAIN["lr"], params=params, mesh=mesh, losses=losses)
    out["train"]["train_lstm_losses"] = losses
    lap("train_lstm(mesh=)")
    pruned, masks = lstm_policy(0.75, 0.5).compile(params).prune(params)
    mstep = jit_train_step(mesh, model, arch, oc, batch, masks)
    pm, om = pruned, init_state(oc, pruned)
    for i in range(SHARD13["masked"]):
        pm, om, _ = mstep(pm, om, batch, 1 + i)
    from repro_torch.sparse.policy import _map_with_path
    paths = leaves(_map_with_path(model.param_defs(), lambda ps, _: ps))
    nonzero = 0
    for ps, x, m, v, psh, osh in zip(paths, leaves(pm), leaves(om["m"]),
                                     leaves(om["v"]), leaves(p_sh),
                                     leaves(o_sh["m"])):
        if ps not in masks:
            continue
        mp = shard_local(masks[ps], mesh, psh.placements)
        mo = shard_local(masks[ps], mesh, osh.placements)
        nonzero += (int(x.to_local()[~mp].count_nonzero())
                    + int(m.to_local()[~mo].count_nonzero())
                    + int(v.to_local()[~mo].count_nonzero()))
    out["masked"] = dict(nonzero=nonzero)
    lap("masked steps")
    # compression: the local gradient pieces over the axis of 2 ranks, on
    # the card and their host copies
    axis = "data" if dict(zip(names, shape))["data"] > 1 else "model"
    gl = {str(i): x.to_local().contiguous() for i, x in
          enumerate(leaves(step.grads(params, batch)[1]))}
    res = compression.init_residuals(gl)
    m_card, r_card = compression.tree_compressed_psum(gl, axis, res,
                                                      mesh=mesh)
    m_host, r_host = compression.tree_compressed_psum(
        {k: v.cpu() for k, v in gl.items()}, axis,
        {k: v.cpu() for k, v in res.items()}, mesh=mesh)
    out["compression"] = dict(
        axis=axis, bitwise=all(torch.equal(m_card[k].cpu(), m_host[k])
                               and torch.equal(r_card[k].cpu(), r_host[k])
                               for k in gl),
        wire=(compression.wire_bytes(gl, True),
              compression.wire_bytes(gl, False)))
    del gl, res, m_card, r_card, m_host, r_host
    lap("compression")
    ckpt = CheckpointManager(ckpt_dir, async_save=False)
    if shape == (2, 2):
        ckpt.save(SHARD13["ckpt_step"], (pm, om))
        out["saved"] = [digest(x) for x in leaves((pm, om))]
        lap("checkpoint save")
    else:
        (rp, ro), meta = elastic_restore(ckpt, (params, init_state(
            oc, params)), (p_sh, o_sh))
        out["restored"] = dict(step=meta["step"],
                               pieces=[digest(x) for x in leaves((rp, ro))])
        del rp, ro
        lap("elastic restore")
    del pm, om, params, pruned, step, mstep
    torch.cuda.empty_cache()
    out["split"] = split13(torch, device, mesh, single_toks, lap)
    out["placements"] = {"p": [tuple(sh.placements) for sh in leaves(p_sh)],
                         "o": [tuple(sh.placements) for sh in
                               leaves((p_sh, o_sh))]}
    return out


def split13(torch, device, mesh, single_toks, lap) -> dict:
    """qwen3-0.6b split-KV on this rank: one greedy generate with the
    launch counts set to 0 just before and read just after (B14 with
    ``lse`` counted apart), then the single-card tokens teacher-forced
    through the split-KV model for SPLIT["tf"] steps (its logits kept at
    SPLIT["tf_steps"]; the prefill and the decode steps timed apart)."""
    from repro_torch.dist.collective_ops import batch_rows
    from repro_torch.kernels import decode_attention as kda
    from repro_torch.kernels import ops
    from repro_torch.serving import ServeEngine
    cfg, model, params, tokens = split_inputs(torch, device)
    B, P, G = SPLIT["batch"], SPLIT["prompt"], SPLIT["gen"]
    eng = ServeEngine(model, max_len=P + G, device=device, mesh=mesh)
    p, _ = eng.prepare(params)
    del params
    torch.cuda.empty_cache()
    lap("split prepare")
    zero_launches(ops)
    kda.LSE_LAUNCHES[0] = 0
    t0 = time.perf_counter()
    toks, st = eng.generate(p, tokens, G, return_state=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: n for k, n in ops.LAUNCHES.items() if n}
    lse = kda.LSE_LAUNCHES[0]
    lap("split generate")
    rows = batch_rows(mesh, B)
    want = torch.as_tensor(single_toks).to(device)[rows]
    t0 = time.perf_counter()
    logits, cache = eng.model.prefill(p, tokens[rows], P + G)
    torch.cuda.synchronize()
    pre = time.perf_counter() - t0
    keep = {0: logits[:, 0].float().cpu().numpy()}
    t0 = time.perf_counter()
    for t in range(SPLIT["tf"] - 1):
        logits, cache = eng.model.decode_step(p, cache, want[:, t:t + 1],
                                              P + t)
        if t + 1 in SPLIT["tf_steps"]:
            keep[t + 1] = logits[:, 0].float().cpu().numpy()
    torch.cuda.synchronize()
    step = (time.perf_counter() - t0) / (SPLIT["tf"] - 1)
    lap("split teacher-forced")
    dry = split_step_measures(torch, eng.model, p, cache,
                              want[:, SPLIT["tf"] - 1:SPLIT["tf"]],
                              P + SPLIT["tf"] - 1)
    lap("split step measured")
    return dict(toks=toks.cpu().numpy(), launches=launches, lse=lse,
                wall=wall, prefill=pre, step=step,
                rows=(rows.start, rows.stop), tf=keep, dry=dry)


def split_step_measures(torch, model, params, cache, tok, pos) -> dict:
    """Phase 14's references for one split-KV decode step on this rank:
    the bytes of its param pieces and cache segment, the peak the step
    allocates above what was live before it, its aten FLOPs, and (a
    second step, under torch.profiler) its collectives."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.obs.collectives import inventory
    from repro_torch.training.tree import leaves
    held = {"params": sum((x.to_local() if hasattr(x, "to_local") else x)
                          .nbytes for x in leaves(params)),
            "cache": sum(x.nbytes for x in leaves(cache))}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as fl:
        _, cache = model.decode_step(params, cache, tok, pos)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    inv = inventory(model.decode_step, params, cache, tok, pos + 1)
    return dict(held=held, peak=peak, flops=fl.get_total_flops(),
                batch=tok.nbytes,
                colls=[(it["kind"], it["bytes"]) for it in inv])


def sharded_phase(torch, device) -> dict:
    """Phase 13: sharded training and split-KV decode on (data, model)
    meshes (2, 2) then (1, 2), every rank a spawned process on this card
    under gloo (each collective staged through host memory).

    Training, full-width lstm_ptb on ZipfInduction(10000), B=16, T=35:
    the sharded (tensor-parallel) step's loss and gradients held to this
    card's one-device step (STEP_LOSS_RTOL, STEP_GRAD_RTOL of each leaf's
    max), every rank's loss bitwise and every replicated piece bitwise
    across the ranks that share it; a rank's FLOPs 1 / (data · model) of
    one device's (within 1%), its held pieces plus a step's peak at most
    SHARD13_MEM of one card's; ``train_lstm(mesh=)`` for
    SHARD13["steps"] dense steps, each loss held to the one-device
    ``train_lstm``'s (STEP_LOSS_RTOL); masked steps with every pruned entry and its moments exactly 0;
    ``tree_compressed_psum`` of the gradient pieces on card tensors
    bitwise that of their host copies; the (2, 2) ranks' checkpoint
    (full arrays, written once) restored onto (1, 2) by
    ``elastic_restore``, every piece bitwise the checkpoint's.

    Split-KV decode, qwen3-0.6b at full width in bf16, B=8, prompt 512,
    gen 16: per rank 28 B15 launches (its prefill) and 28 B14 launches a
    decode step, every one with ``lse``; greedy tokens equal to the
    single-card path's up to each row's first top-2 margin below
    TF_MARGIN; the single-card tokens teacher-forced through the split-KV
    model for SPLIT["tf"] steps within TF_LOGIT_TOL of the single-card
    teacher-forced logits.

    Returns rank 0's measures for phase 14, by mesh: a train step's and a
    split-KV decode step's (``split_step_measures``)."""
    import shutil
    import types
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.launch import pipeline as pl
    from repro_torch.serving import ServeEngine
    from repro_torch.training import (CheckpointManager, OptConfig,
                                      init_state, make_train_step)
    from repro_torch.training.tree import leaves
    torch.cuda.empty_cache()
    B, P, G = SPLIT["batch"], SPLIT["prompt"], SPLIT["gen"]
    # the single-card references, before any rank holds the card
    cfg, model, params, tokens = split_inputs(torch, device)
    eng = ServeEngine(model, max_len=P + G, device=device)
    out1, st1 = eng.generate(params, tokens, G, return_state=True)
    tf1 = tf_logits(torch, model, params, tokens, out1, P + G)
    top2 = tf1[..., :cfg.vocab_size].topk(2, dim=-1).values
    small = (top2[..., 0] - top2[..., 1]) < TF_MARGIN
    first = torch.where(small.any(1), small.float().argmax(1),
                        torch.full((B,), G, device=device)).tolist()
    tf1 = {t: tf1[:, t].float().cpu() for t in SPLIT["tf_steps"]}
    single = out1.cpu().numpy()
    del eng, params, st1
    torch.cuda.empty_cache()
    lmodel, lparams, corpus, batch, pcfg = lstm13_inputs(torch, device)
    want_losses = []
    pl.train_lstm(lmodel, corpus, pcfg, steps=SHARD13["steps"],
                  lr=TRAIN["lr"], params=lparams, losses=want_losses)
    oc = OptConfig(lr=TRAIN["lr"], warmup_steps=1, total_steps=10)
    one = make_train_step(lmodel, types.SimpleNamespace(grad_accum=1), oc)
    p, o, _ = one(lparams, init_state(oc, lparams), batch, 1)
    mem1 = sum(step_memory(torch, one, p, o, batch, 2)[:2])
    del lparams, p, o
    torch.cuda.empty_cache()
    ck = ROOT / "build" / "ckpt13"
    shutil.rmtree(ck, ignore_errors=True)
    runs = {}
    try:
        for mesh in ((2, 2), (1, 2)):
            t0 = time.perf_counter()
            runs[mesh] = run_ranks(shard13_rank, *mesh, device="cuda",
                                   backend="gloo",
                                   args=(time.time(), str(ck), single),
                                   threads=2, timeout=600)
            log(f"[shard] mesh data={mesh[0]} model={mesh[1]}: "
                f"{mesh[0] * mesh[1]} ranks in "
                f"{time.perf_counter() - t0:.1f}s; rank 0's seconds: "
                + json.dumps(runs[mesh][0]["laps"]))
        whole, meta = CheckpointManager(str(ck), async_save=False).restore(
            _ckpt_template(torch, lmodel))
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    if meta["step"] != SHARD13["ckpt_step"]:
        raise AssertionError(f"checkpoint step {meta['step']}")
    for mesh, ranks in runs.items():
        sizes = dict(zip(("data", "model"), mesh))
        tr = [rk["train"] for rk in ranks]
        t = tr[0]
        rel = abs(t["loss"] - t["loss1"]) / abs(t["loss1"])
        log(f"[shard] {mesh}: lstm_ptb sharded grads vs one-device: loss "
            f"{t['loss']:.6f} vs {t['loss1']:.6f} (rel {rel:.2e}, gate "
            f"{STEP_LOSS_RTOL:.0e}); max |dg| / max |g| over the ranks' "
            f"pieces {max(x['grad_rel'] for x in tr):.2e} (gate "
            f"{STEP_GRAD_RTOL:.0e}); a sharded AdamW step "
            f"{[round(x, 3) for x in t['step_s']]} s (gloo host-staged)")
        if not rel <= STEP_LOSS_RTOL or \
                not max(x["grad_rel"] for x in tr) <= STEP_GRAD_RTOL:
            raise AssertionError(f"{mesh}: sharded step off the one-device "
                                 "step")
        if len({x["loss"] for x in tr}) != 1 or \
                len({x["step_loss"] for x in tr}) != 1:
            raise AssertionError(f"{mesh}: ranks' losses differ")
        share = [x["flops"][0] / x["flops"][1] for x in tr]
        mem = [sum(x["mem"]) / mem1 for x in tr]
        log(f"[shard] {mesh}: a rank's FLOPs of its loss and gradient over "
            f"one device's {min(share):.4f}-{max(share):.4f} (1 / "
            f"{mesh[0] * mesh[1]} = {1 / (mesh[0] * mesh[1]):.4f}); held "
            f"pieces + a step's peak above them "
            f"{max(sum(x['mem']) for x in tr) / 2**20:.1f} MiB a rank (held {tr[0]['mem'][0] / 2**20:.1f}, step "
            f"{tr[0]['mem'][1] / 2**20:.1f}) against one card's "
            f"{mem1 / 2**20:.1f}: {max(mem):.3f} (gate {SHARD13_MEM})")
        if any(abs(x * mesh[0] * mesh[1] - 1) > 0.01 for x in share):
            raise AssertionError(f"{mesh}: a rank's FLOPs {share} are not "
                                 "its share of one device's")
        if not max(mem) <= SHARD13_MEM:
            raise AssertionError(f"{mesh}: a rank holds {max(mem):.3f} of "
                                 "one card's memory")
        # ranks at the same model coordinate hold the same param pieces
        by_model = {}
        for rk in ranks:
            by_model.setdefault(rk["coords"]["model"], []).append(
                rk["train"]["pieces"])
        if any(len({tuple(p) for p in ps}) != 1 for ps in by_model.values()):
            raise AssertionError(f"{mesh}: replicated pieces differ")
        got_l = t["train_lstm_losses"]
        dl = max(abs(a - b) / abs(b) for a, b in zip(got_l, want_losses))
        log(f"[shard] {mesh}: train_lstm(mesh=) losses {got_l} vs one "
            f"device {want_losses} (max rel {dl:.2e}); masked steps: "
            f"{sum(rk['masked']['nonzero'] for rk in ranks)} nonzero pruned "
            f"entries in params and moments; compression over "
            f"{ranks[0]['compression']['axis']}: card bitwise host "
            f"{all(rk['compression']['bitwise'] for rk in ranks)}, wire "
            f"bytes int8 / fp32 {ranks[0]['compression']['wire']}")
        if not dl <= STEP_LOSS_RTOL or len(got_l) != SHARD13["steps"]:
            raise AssertionError(f"{mesh}: train_lstm(mesh=) losses")
        if any(rk["masked"]["nonzero"] for rk in ranks):
            raise AssertionError(f"{mesh}: a pruned entry moved")
        if not all(rk["compression"]["bitwise"] for rk in ranks):
            raise AssertionError(f"{mesh}: compression card != host")
        key = "saved" if mesh == (2, 2) else "restored"
        for rk in ranks:
            got = rk[key] if key == "saved" else rk[key]["pieces"]
            want = [digest(piece_of(w, pl_, rk["coords"], sizes))
                    for w, pl_ in zip(leaves(whole), rk["placements"]["o"])]
            if got != want:
                raise AssertionError(f"{mesh}: checkpoint pieces not "
                                     f"bitwise ({key})")
        log(f"[shard] {mesh}: checkpoint pieces {key} bitwise the whole "
            "arrays on disk" + (f" (step {ranks[0]['restored']['step']})"
                                if key == "restored" else ""))
        split_gates(torch, mesh, ranks, single, tf1, first, cfg)
    return {mesh: {"train": ranks[0]["train"]["dry"],
                   "split": ranks[0]["split"]["dry"]}
            for mesh, ranks in runs.items()}


def _ckpt_template(torch, model):
    """(params, AdamW state) of lstm_ptb on the CPU: the checkpoint's
    structure and dtypes."""
    from repro_torch.training import OptConfig, init_state
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    return params, init_state(OptConfig(), params)


def split_gates(torch, mesh, ranks, single, tf1, first, cfg) -> None:
    """Phase 13's split-KV gates on every rank (``sharded_phase``)."""
    B, P, G = SPLIT["batch"], SPLIT["prompt"], SPLIT["gen"]
    L = cfg.num_layers
    want = {"flash_attention": L, "decode_attention": L * G}
    for rk in ranks:
        sp = rk["split"]
        if sp["launches"] != want or sp["lse"] != L * G:
            raise AssertionError(f"{mesh} rank {rk['rank']}: launches "
                                 f"{sp['launches']}, with lse {sp['lse']}; "
                                 f"expected {want}, all B14 with lse")
        toks = sp["toks"]
        same = [bool(np.array_equal(toks[b, :first[b]], single[b, :first[b]]))
                for b in range(B)]
        lo, hi = sp["rows"]
        dl = max(float(np.abs(sp["tf"][t] - tf1[t][lo:hi].numpy())
                       [..., :cfg.vocab_size].max())
                 for t in SPLIT["tf_steps"])
        if not all(same) or not dl <= TF_LOGIT_TOL:
            raise AssertionError(f"{mesh} rank {rk['rank']}: tokens equal "
                                 f"up to small margins {same}; teacher-"
                                 f"forced logits {dl:.3e}")
        rk["split_dl"] = dl
    sp = ranks[0]["split"]
    same = int((sp["toks"] == single).sum())
    log(f"[shard] {mesh}: qwen3-0.6b split-KV ({cfg.dtype}, B={B}, prompt "
        f"{P}, gen {G}): launches a rank {sp['launches']}, B14 with lse "
        f"{sp['lse']} = {L} a decode step; teacher-forced logits vs single "
        f"card max |diff| {max(rk['split_dl'] for rk in ranks):.3e} (tol "
        f"{TF_LOGIT_TOL}); greedy tokens equal per row up to its first top-2 "
        f"margin < {TF_MARGIN} (steps {first}), {same} of {B * G} equal; "
        f"generate {sp['wall']:.2f} s; teacher-forced: prefill "
        f"(tensor-parallel, B15 on the rank's heads) {sp['prefill']:.2f} s, "
        f"a decode step {sp['step'] * 1e3:.1f} ms (gloo host-staged) on "
        "rank 0")


def zsplit_model(torch, arch, device):
    """Phase 15's (cfg, model, tokens, extra) of ``arch`` (ZSPLIT): its
    config at the depth kept, the prompt (CPU generator, seed 1) and the
    frames or patches (seed 2), on ``device``."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    R = ZSPLIT[arch]
    full = get_arch(arch)
    cfg = full.with_(num_layers=R.get("layers", full.num_layers),
                     kv_quant=R.get("kv_quant", False))
    B, P = R["batch"], R["prompt"]
    tokens = torch.randint(0, cfg.vocab_size, (B, P), generator=torch
                           .Generator().manual_seed(1)).to(device)
    rows = R.get("frames") if cfg.encdec else cfg.num_patches
    extra = None
    if rows:
        extra = torch.randn((B, rows, cfg.d_model), generator=torch
                            .Generator().manual_seed(2)).to(
                                device, cfg.torch_dtype)
    return cfg, build_model(cfg), tokens, extra


class RouteLog:
    """Records ``moe.route``'s expert ids (on the host) of every call
    while on."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.real, self.ids = moe, moe.route, []

    def __enter__(self):
        def route(*a, **kw):
            out = self.real(*a, **kw)
            self.ids.append(out[0].cpu().numpy())
            return out
        self.moe.route = route
        return self.ids

    def __exit__(self, *exc):
        self.moe.route = self.real


class SegmentLog:
    """Records the split-KV writes into the first attention layer's int8
    segment (``splitkv._keep_prompt`` / ``write_segment``), to replay
    through the one-device ``kv_cache_update``."""

    def __init__(self, layers: int):
        from repro_torch.dist import splitkv
        self.sk, self.layers, self.calls = splitkv, layers, []
        self.real = (splitkv._keep_prompt, splitkv.write_segment)

    def __enter__(self):
        keep, write = self.real
        n = [0]

        def log_keep(cache, k, v, s0):
            if n[0] % self.layers == 0:
                self.calls.append(("prompt", k.clone(), v.clone(), None))
            n[0] += 1
            return keep(cache, k, v, s0)

        def log_write(cache, k, v, pos_b, s0):
            if n[0] % self.layers == 0:
                self.calls.append(("step", k.clone(), v.clone(),
                                   pos_b.clone()))
            n[0] += 1
            return write(cache, k, v, pos_b, s0)
        self.sk._keep_prompt, self.sk.write_segment = log_keep, log_write
        return self.calls

    def __exit__(self, *exc):
        self.sk._keep_prompt, self.sk.write_segment = self.real


@contextlib.contextmanager
def hold_moe(torch, net, params, ids):
    """While on, each call of the split-KV model's expert-parallel MoE
    (``TensorParallel.moe``) on its first MoE layer is also computed by
    the one-device ``moe_apply`` on the layer's whole weights (gathered
    once) and the same input: yields a list of (expert ids equal, aux
    bitwise, max |out - one device's| over max |one device's|), one a
    call. ``ids``: the ``RouteLog`` of the run, whose entry for the
    one-device call is taken back out."""
    from repro_torch.dist.collective_ops import full_tensor
    from repro_torch.models.moe import moe_apply
    first = params["layers"][0]["moe"]
    whole = {k: full_tensor(v) for k, v in first.items()}
    tp = net.tp
    real = tp.moe
    seen = []

    def moe(pm, x, **kw):
        y, aux = real(pm, x, **kw)
        if pm is first:
            y1, aux1 = moe_apply(whole, x, **kw)
            one = ids.pop()
            seen.append((bool(np.array_equal(ids[-1], one)),
                         bool(torch.equal(aux, aux1)),
                         ((y.float() - y1.float()).abs().max()
                          / y1.float().abs().max()).item()))
        return y, aux
    tp.moe = moe
    try:
        yield seen
    finally:
        del tp.moe


def int8_replay_bitwise(torch, cfg, calls, segment, s0, max_len) -> bool:
    """The first layer's int8 segment (codes and scales) bitwise the same
    writes through the one-device ``kv_cache_update`` into a whole cache
    of ``max_len`` positions, at the segment's positions."""
    from repro_torch.models import attention as A
    from repro_torch.models.layers import init_params
    whole = init_params(A.kv_cache_defs(
        calls[0][1].shape[0], max_len, cfg.num_kv_heads, cfg.head_dim,
        cfg.torch_dtype, quant=True), None, calls[0][1].device)
    for kind, k, v, pos in calls:
        A.kv_cache_update(whole, k, v, 0 if kind == "prompt" else pos)
    seg = segment["k"].shape[1]
    return all(torch.equal(leaf, whole[n][:, s0:s0 + seg])
               for n, leaf in segment.items())


def zsplit_single(torch, device) -> dict:
    """Phase 15's single-card references of each arch, before any rank
    holds the card: greedy tokens (gen ZGEN), each row's first top-2
    margin below TF_MARGIN, the teacher-forced logits at ZTF_STEPS, the
    MoE's expert ids of every call of that teacher-forced run, and the
    one-card params' bytes."""
    import gc
    from repro_torch.models.layers import param_bytes
    from repro_torch.serving import ServeEngine
    refs = {}
    for arch, R in ZSPLIT.items():
        cfg, model, tokens, extra = zsplit_model(torch, arch, device)
        B, P = tokens.shape
        params = model.init(torch.Generator(device).manual_seed(0), device)
        if R.get("fan_in", True):
            params = fan_in_qk(params)
        eng = ServeEngine(model, max_len=P + ZGEN, device=device)
        out = eng.generate(params, tokens, ZGEN, extra=extra)
        with RouteLog() as ids:
            tf = tf_logits(torch, model, params, tokens, out, P + ZGEN,
                           extra)
        top2 = tf[..., :cfg.vocab_size].topk(2, dim=-1).values
        small = (top2[..., 0] - top2[..., 1]) < TF_MARGIN
        first = torch.where(small.any(1), small.float().argmax(1),
                            torch.full((B,), ZGEN, device=device)).tolist()
        refs[arch] = dict(
            out=out.cpu(), first=first, ids=ids,
            tf={t: tf[:, t, :cfg.vocab_size].float().cpu()
                for t in ZTF_STEPS},
            param_bytes=param_bytes(model.param_defs()))
        del eng, params, out, tf
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return refs


def zsplit_rank(mesh, spawned: float, archs, refs, device_type: str) -> dict:
    """Phase 15 on one rank: for each arch of ``archs``, the sharded init
    (its card memory right after it), a greedy ``generate`` through
    ``ServeEngine(mesh=)`` with the launch counts set to 0 just before and
    read just after, then the single-card tokens teacher-forced through
    the split-KV model with every B14 / B15 launch held to its plain
    version on the rank's own inputs (``held_calls``), its MoE expert ids
    and its first layer's int8 writes recorded (``RouteLog``,
    ``SegmentLog``); its prefill and decode steps timed."""
    faulthandler.enable(all_threads=True)
    import gc
    import torch
    import torch.distributed as dist
    from repro_torch.dist.collective_ops import batch_rows
    from repro_torch.dist.splitkv import cache_segment
    from repro_torch.kernels import decode_attention as kda
    from repro_torch.kernels import ops
    from repro_torch.models.layers import init_params
    from repro_torch.serving import ServeEngine
    from repro_torch.training.train_loop import param_shardings
    cuda = device_type == "cuda"
    device = (torch.device("cuda", torch.cuda.current_device()) if cuda
              else torch.device(device_type))
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    allocated = torch.cuda.memory_allocated if cuda else (lambda: 0)
    out = {"rank": dist.get_rank(), "start": time.time() - spawned,
           "coords": {a: mesh.get_local_rank(a)
                      for a in mesh.mesh_dim_names}}
    for arch in archs:
        t_arch = time.perf_counter()
        R, ref = ZSPLIT[arch], refs[arch]
        cfg, model, tokens, extra = zsplit_model(torch, arch, device)
        B, P = tokens.shape
        ML = P + ZGEN
        sync()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        base = allocated()
        params = init_params(model.param_defs(),
                             torch.Generator(device).manual_seed(0), device,
                             shardings=param_shardings(mesh, model))
        sync()
        held = allocated() - base
        if R.get("fan_in", True):
            params = fan_in_qk(params)
        eng = ServeEngine(model, max_len=ML, device=device, mesh=mesh)
        p, _ = eng.prepare(params)
        del params
        zero_launches(ops)
        kda.LSE_LAUNCHES[0] = 0
        t0 = time.perf_counter()
        toks = eng.generate(p, tokens, ZGEN, extra=extra)
        sync()
        wall = time.perf_counter() - t0
        launches = {k: n for k, n in ops.LAUNCHES.items() if n}
        lse = kda.LSE_LAUNCHES[0]
        rows = batch_rows(mesh, B)
        want = ref["out"].to(device)[rows]
        kw = {} if extra is None else {"extra": extra[rows]}
        net = eng.model
        layers = sum(k.startswith("attn") for k in getattr(
            net, "kinds", ())) or net.n_dec
        rec = {}

        def teacher_forced():
            t0 = time.perf_counter()
            logits, cache = net.prefill(p, tokens[rows], ML, **kw)
            sync()
            rec["prefill"] = time.perf_counter() - t0
            kept = {0: logits[:, 0, :cfg.vocab_size].float().cpu()}
            t0 = time.perf_counter()
            for t in range(ZGEN - 1):
                logits, cache = net.decode_step(p, cache, want[:, t:t + 1],
                                                P + t)
                if t + 1 in ZTF_STEPS:
                    kept[t + 1] = logits[:, 0, :cfg.vocab_size].float().cpu()
            sync()
            rec["step"] = (time.perf_counter() - t0) / (ZGEN - 1)
            rec["tf"], rec["cache"] = kept, cache
        with RouteLog() as ids, SegmentLog(layers) as writes:
            held_moe = (hold_moe(torch, net, p, ids) if R.get("hold_moe")
                        else contextlib.nullcontext([]))
            with held_moe as moe_seen:
                calls, err, scale = held_calls(torch, teacher_forced)
        s0 = cache_segment(mesh, ML)[0]
        int8 = None
        if cfg.kv_quant:
            int8 = int8_replay_bitwise(torch, cfg, writes,
                                       rec["cache"]["layers"][0], s0, ML)
        lo, hi = rows.start, rows.stop
        dl = max(float((rec["tf"][t] - ref["tf"][t][lo:hi]).abs().max())
                 for t in ZTF_STEPS)
        same_ids = sum(int((a == b[lo:hi]).sum())
                       for a, b in zip(ids, ref["ids"]))
        n_ids = sum(a.size for a in ids)
        out[arch] = dict(
            held=held, toks=toks.cpu().numpy(), launches=launches, lse=lse,
            wall=wall, prefill=rec["prefill"], step=rec["step"],
            calls=calls, err=err, scale=scale, dl=dl, rows=(lo, hi),
            ids=[digest(torch.as_tensor(a)) for a in ids],
            same_ids=same_ids, n_ids=n_ids, moe_held=moe_seen,
            ref_ids=len(ids) == len(ref["ids"]), int8=int8,
            seconds=time.perf_counter() - t_arch)
        del eng, p, rec, writes
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    return out


def splitkv_zoo(torch, device) -> None:
    """Phase 15: split-KV serving of the rest of the attention zoo, every
    rank a spawned process on this card under gloo: ZSPLIT's five archs at
    full width in bf16 on (1, 2), granite-moe on (2, 2) at the same time
    (ZSPLIT_MESHES;
    llava-next-34b cut to 6 layers, llama3.2-3b to 6 with the int8 cache,
    qwen3-moe-235b-a22b to 2 with all 128 experts; granite-moe and
    seamless-m4t at full depth).

    Gates, each on every rank: the sharded init's card memory right after
    it at most ZSPLIT_MEM of the one-card params' bytes (no rank holds
    whole params); a generate's launches (set to 0 just before, read just
    after) those of one card (``expected_launches``), every B14 with
    ``lse``; every B14 / B15 launch of a teacher-forced run within one
    bf16 ulp of its largest output of its plain version on the rank's own
    inputs (``held_calls``); the single-card tokens teacher-forced through
    the split-KV model within TF_LOGIT_TOL of the single-card logits at
    ZTF_STEPS; greedy tokens equal to the single card's up to each row's
    first top-2 margin below TF_MARGIN; the MoE's expert ids bitwise alike
    on the ranks of a model group (each rank routes alike) and, on
    granite-moe's first MoE layer (``hold_moe``), equal to the one-device
    ``moe_apply``'s on the same input, its aux bitwise and its output
    within two bf16 ulps of its largest; the int8
    segment's codes and scales bitwise the one-device ``kv_cache_update``
    of the same writes. Printed: the expert ids' agreement with the single
    card's (bf16 sums over ranks move the router's input by ulps), the
    wall a decode step a rank and the launches of one decode step. End-to-
    end gates with ``wq`` / ``wk`` at the fan-in scale (``fan_in_qk``),
    qwen3-moe on its own weights, as phase 11."""
    import concurrent.futures
    from repro_torch.launch.mesh import run_ranks
    refs = zsplit_single(torch, device)

    def spawn(mesh, archs):
        t0 = time.perf_counter()
        ranks = run_ranks(zsplit_rank, *mesh, device=device.type,
                          backend="gloo",
                          args=(time.time(), archs,
                                {a: refs[a] for a in archs}, device.type),
                          threads=2, timeout=600)
        return ranks, time.perf_counter() - t0
    # the meshes' ranks side by side: each mesh's start-up and host-staged
    # collectives overlap the other's
    with concurrent.futures.ThreadPoolExecutor(len(ZSPLIT_MESHES)) as pool:
        futs = {m: pool.submit(spawn, m, a) for m, a in ZSPLIT_MESHES.items()}
        done = {m: f.result() for m, f in futs.items()}
    for mesh, archs in ZSPLIT_MESHES.items():
        ranks, took = done[mesh]
        log(f"[zsplit] mesh data={mesh[0]} model={mesh[1]}: "
            f"{mesh[0] * mesh[1]} ranks in {took:.1f}s, beside the other "
            f"mesh's (rank 0 reached the card after {ranks[0]['start']:.1f}"
            "s)")
        for arch in archs:
            zsplit_gates(torch, arch, mesh, ranks, refs[arch])


def zsplit_gates(torch, arch, mesh, ranks, ref) -> None:
    """Phase 15's gates of ``arch`` on ``mesh`` (``splitkv_zoo``)."""
    cfg, model, _, _ = zsplit_model(torch, arch, "cpu")
    every = expected_launches(model, ZGEN)
    step = {k: v // ZGEN for k, v in every.items() if k == "decode_attention"}
    for rk in ranks:
        want = every
        r = rk[arch]
        tag = f"{arch} {mesh} rank {rk['rank']}"
        if cfg.pad_heads_to:
            # a rank whose block of stored q heads holds no real head
            # launches no B15
            hq = model.h_eff // mesh[1]
            if rk["coords"]["model"] * hq >= cfg.num_heads:
                want = dict(want, flash_attention=0)
        share = r["held"] / ref["param_bytes"]
        if mesh == (1, 2) and not share <= ZSPLIT_MEM:
            raise AssertionError(f"{tag}: holds {share:.3f} of the one-card "
                                 f"params after the sharded init")
        got = {k: n for k, n in want.items() if n}
        if r["launches"] != got or r["lse"] != want["decode_attention"]:
            raise AssertionError(f"{tag}: launches {r['launches']}, lse "
                                 f"{r['lse']}; expected {want}")
        hwant = (want["flash_attention"]
                 + want["decode_attention"] // ZGEN * (ZGEN - 1))
        if r["calls"] != hwant:
            raise AssertionError(f"{tag}: {r['calls']} launches held, "
                                 f"expected {hwant}")
        lo, hi = r["rows"]
        first = ref["first"][lo:hi]
        single = ref["out"].numpy()[lo:hi]
        same = [bool(np.array_equal(r["toks"][lo:hi][b, :f], single[b, :f]))
                for b, f in enumerate(first)]
        if not all(same) or not r["dl"] <= TF_LOGIT_TOL:
            raise AssertionError(f"{tag}: tokens equal up to small margins "
                                 f"{same}; teacher-forced logits "
                                 f"{r['dl']:.3e}")
        if cfg.moe and not r["ref_ids"]:
            raise AssertionError(f"{tag}: MoE calls differ in number")
        held = r["moe_held"]
        if ZSPLIT[arch].get("hold_moe") and not (
                len(held) == ZGEN and all(i and a and e <= 2 * BF16_ULP
                                          for i, a, e in held)):
            raise AssertionError(f"{tag}: the expert-parallel MoE off the "
                                 f"one-device moe_apply: {held}")
        if cfg.kv_quant and not r["int8"]:
            raise AssertionError(f"{tag}: int8 segment not bitwise the "
                                 "one-device cache update")
    if cfg.moe:
        by_rows = {}
        for rk in ranks:
            by_rows.setdefault(rk["coords"]["data"], []).append(
                rk[arch]["ids"])
        if any(len({tuple(x) for x in v}) != 1 for v in by_rows.values()):
            raise AssertionError(f"{arch} {mesh}: the ranks of a model "
                                 "group route differently")
    r = ranks[0][arch]
    agree = (f"; expert ids equal to the single card's at "
             f"{sum(rk[arch]['same_ids'] for rk in ranks)} of "
             f"{sum(rk[arch]['n_ids'] for rk in ranks)} (token, slot, "
             f"layer) choices, alike on the ranks of a model group"
             if cfg.moe else "")
    int8 = ("; int8 segment codes and scales bitwise the one-device "
            "cache update" if cfg.kv_quant else "")
    if ZSPLIT[arch].get("hold_moe"):
        worst = max(e for rk in ranks for _, _, e in rk[arch]["moe_held"])
        agree += (f"; the first MoE layer's {len(r['moe_held'])} calls "
                  "against the one-device moe_apply on the same input: "
                  f"expert ids and aux exact, outputs within {worst:.3e} of "
                  f"max |out| (gate {2 * BF16_ULP:.3e})")
    held = max(rk[arch]["held"] for rk in ranks)
    log(f"[zsplit] {arch} {mesh}: {cfg.num_layers} layers"
        + (f" (+{model.n_enc} encoder)" if cfg.encdec else "")
        + f"; init: rank memory {held / 2**30:.3f} GiB = "
        f"{held / ref['param_bytes']:.3f} of the one-card params "
        f"({ref['param_bytes'] / 2**30:.3f} GiB; gate {ZSPLIT_MEM} at "
        "(1, 2)); "
        f"launches a rank a generate {r['launches']}, a decode step {step}, "
        f"all B14 with lse; {r['calls']} B14 / B15 launches held to plain "
        f"(max |err| {max(rk[arch]['err'] for rk in ranks):.3e}, max |out| "
        f"{max(rk[arch]['scale'] for rk in ranks):.3e}); teacher-forced "
        f"logits vs single card {max(rk[arch]['dl'] for rk in ranks):.3e} "
        f"(tol {TF_LOGIT_TOL}); greedy tokens equal up to first margins "
        f"< {TF_MARGIN}" + agree + int8
        + f"; rank 0: generate {r['wall']:.2f} s, prefill {r['prefill']:.2f}"
        f" s, a decode step {r['step'] * 1e3:.1f} ms (gloo host-staged), "
        f"{r['seconds']:.1f} s in all")


def check_decode_start(torch, device, flush) -> dict:
    """Phase 16, B14's ``start=`` alone at recurrentgemma-9b's rank-0
    segment (B=4, 16 q heads on one kv head of 256, bf16, the segment's
    1284 rows all live): one row's first key inside the segment (513, the
    window's edge), one at its length, one past it, one at 0; ``o``
    within one bf16 ulp of the plain version's and ``lse`` within
    LSE_ATOL, the rows from or past their length 0 / -inf, ``start=`` of
    zeros bitwise the launch without it; timed with and without ``start``
    (L2 flushed)."""
    from repro_torch.kernels import decode_attention as kda
    from repro_torch.kernels import ops
    from repro_torch.kernels._build import time_ms
    B, Hq, D, S = 4, 16, 256, 1284
    q, k, v = attn_case(torch, device, torch.bfloat16, B=B, Hq=Hq, Hkv=1,
                        Sq=1, Sk=S, D=D, seed=16)
    q = q[:, :, 0]
    n = torch.full((B,), S, dtype=torch.int32, device=device)
    start = torch.tensor([513, S, S + 16, 0], dtype=torch.int32,
                         device=device)
    lse, want_lse = (torch.empty(B, Hq, device=device) for _ in range(2))
    n0 = kda.START_LAUNCHES[0]
    o = ops.decode_attention(q, k, v, n, start=start, lse=lse,
                             backend="cuda")
    want = ops.decode_attention(q, k, v, n, start=start, lse=want_lse,
                                backend="ref")
    err = attn_held(torch, "decode_attention", o, want,
                    "start= (513, len, past len, 0) at D=256, 1284 rows",
                    n_keys=S)
    hold_lse(torch, lse, want_lse)
    dead = start >= n
    if not (torch.isneginf(lse[dead]).all() and not o[dead].any()):
        raise AssertionError("decode_attention start >= len: not 0 / -inf")
    zero = torch.zeros(B, dtype=torch.int32, device=device)
    if not torch.equal(ops.decode_attention(q, k, v, n, start=zero,
                                            backend="cuda"),
                       ops.decode_attention(q, k, v, n, backend="cuda")):
        raise AssertionError("decode_attention start=0 differs from the "
                             "launch without start")
    if kda.START_LAUNCHES[0] != n0 + 2:
        raise AssertionError("START_LAUNCHES does not count start= launches")
    edge = torch.full((B,), 513, dtype=torch.int32, device=device)
    ms = time_ms(lambda: ops.decode_attention(q, k, v, n, start=edge,
                                              lse=lse, backend="cuda"), flush)
    ms0 = time_ms(lambda: ops.decode_attention(q, k, v, n, lse=lse,
                                               backend="cuda"), flush)
    plain = time_ms(lambda: ops.decode_attention(q, k, v, n, start=edge,
                                                 lse=lse, backend="ref"),
                    flush)
    kv = k[:, :, 513:].repeat_interleave(Hq, 1), \
        v[:, :, 513:].repeat_interleave(Hq, 1)
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None], *kv), flush)
    live = B * (S - 513) * 2 * D * 2           # the live keys and values
    bnd, by = bound(live + q.numel() * 2 * 2 + lse.numel() * 4, 0,
                    bf16_flops=ATTN_FLOPS * B * Hq * (S - 513) * D)
    log(f"[time] decode_attention start=513 of 1284 rows, B=4, 16/1 heads "
        f"of 256, bf16, with lse: {ms:.4f} ms (without start, all 1284 "
        f"rows: {ms0:.4f}); plain {plain:.4f}; SDPA over the live rows "
        f"{lib:.4f}; bound {bnd * 1e3:.2f} us ({by}) — median of 30, L2 "
        f"flushed; max |err| {err:.3e}")


def rsplit_model(torch, arch, device, layers=None):
    """Phase 16's (cfg, model, tokens) of ``arch`` (RSPLIT): its config at
    ``layers`` (RSPLIT's, or the whole depth), the prompt (CPU generator,
    seed 1) on ``device``."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    R = RSPLIT[arch]
    full = get_arch(arch)
    cfg = full.with_(num_layers=layers or R.get("layers", full.num_layers))
    tokens = torch.randint(0, cfg.vocab_size, (R["batch"], R["prompt"]),
                           generator=torch.Generator().manual_seed(1)
                           ).to(device)
    return cfg, build_model(cfg), tokens


def sched16_requests(V: int) -> list:
    """RSCHED's requests: [(prompt (1, S) ids, budget)], seed 0."""
    g = np.random.default_rng(0)
    return [(g.integers(0, V, (1, int(g.integers(RSCHED["prompt"][0],
                                                 RSCHED["prompt"][1] + 1)))),
             int(g.integers(RSCHED["budget"][0], RSCHED["budget"][1] + 1)))
            for _ in range(RSCHED["requests"])]


def first_margins(torch, tf, V: int, n: int) -> list:
    """Each row's first generated position whose top-2 margin (of the
    teacher-forced logits ``tf`` (B, G, Vp)) is below TF_MARGIN, else
    ``n``."""
    top2 = tf[..., :V].topk(2, dim=-1).values
    small = (top2[..., 0] - top2[..., 1]) < TF_MARGIN
    return torch.where(small.any(1), small.float().argmax(1),
                       torch.full((tf.shape[0],), n,
                                  device=tf.device)).tolist()


def rsplit_single(torch, device) -> dict:
    """Phase 16's single-card references, before any rank holds the card:
    (a) and (b) greedy tokens (gen RGEN), each row's first top-2 margin
    below TF_MARGIN, the teacher-forced logits of every generated
    position and the params' bytes, rwkv6-7b at the depth its one-ulp
    spreads pick (each printed); (c) the one-card scheduler's tokens of
    RSCHED's requests and each request's first small margin."""
    import gc
    from repro_torch.models import build_model
    from repro_torch.models.layers import param_bytes
    from repro_torch.serving import ServeEngine
    from repro_torch.serving.scheduler import ContinuousBatchingEngine
    from repro_torch.sparse import use_backend
    refs = {}
    for arch in RSPLIT:
        depth = None
        if arch == "rwkv6-7b":
            # the deepest depth whose spread stays under a quarter of the
            # gate, else the least (its spread printed beside the gate)
            spreads, tops = {}, {}
            for d in RWKV_DEPTHS:
                cfg, model, tokens = rsplit_model(torch, arch, device, d)
                params = model.init(torch.Generator(device).manual_seed(0),
                                    device)
                ML = tokens.shape[1] + RGEN
                with use_backend("ref"):
                    lr, _ = model.prefill(params, tokens, ML)
                spreads[d] = one_ulp_spread(torch, model, params, tokens,
                                            ML, lr)
                tops[d] = lr[..., :cfg.vocab_size].abs().max().item()
                del params, lr
                if spreads[d] >= TF_LOGIT_TOL / 4:
                    break
                depth = d
            log(f"[rsplit] rwkv6-7b one-ulp spread of the prefill logits "
                f"by depth {spreads} (max |logit| {tops}; a depth under "
                f"{TF_LOGIT_TOL / 4} is kept): "
                + (f"depth {depth}" if depth else
                   f"none under it, the gates at depth {RWKV_DEPTHS[0]}, "
                   f"whose spread is {spreads[RWKV_DEPTHS[0]]:.3e} of the "
                   f"gate's {TF_LOGIT_TOL}"))
            depth = depth or RWKV_DEPTHS[0]
        cfg, model, tokens = rsplit_model(torch, arch, device, depth)
        B, P = tokens.shape
        params = model.init(torch.Generator(device).manual_seed(0), device)
        if RSPLIT[arch].get("fan_in"):
            params = fan_in_qk(params)
        eng = ServeEngine(model, max_len=P + RGEN, device=device)
        out = eng.generate(params, tokens, RGEN)
        tf = tf_logits(torch, model, params, tokens, out, P + RGEN)
        refs[arch] = dict(out=out.cpu(), layers=cfg.num_layers,
                          first=first_margins(torch, tf, cfg.vocab_size,
                                              RGEN),
                          tf=tf[..., :cfg.vocab_size].float().cpu(),
                          param_bytes=param_bytes(model.param_defs()))
        del eng, params, out, tf
        gc.collect()
        torch.cuda.empty_cache()
    from repro_torch.configs import get_arch
    cfg = get_arch(SCHED16["arch"]).with_(num_layers=SCHED16["layers"])
    model = build_model(cfg)
    params = model.init(torch.Generator(device).manual_seed(0), device)
    reqs = sched16_requests(cfg.vocab_size)
    sched = ContinuousBatchingEngine(model, params, slots=RSCHED["slots"],
                                     max_len=RSCHED["max_len"], device=device)
    uids = [sched.submit(p, b) for p, b in reqs]
    res = sched.run()
    toks, first = [], []
    for (p, b), u in zip(reqs, uids):
        t = torch.as_tensor(res[u], device=device)
        seq = torch.cat([torch.from_numpy(p).to(device), t[None].long()], 1)
        with torch.no_grad():
            lg = model.forward(params, seq)[0][:, p.shape[1] - 1:-1]
        first.append(first_margins(torch, lg, cfg.vocab_size, len(t))[0])
        toks.append(res[u])
    refs["sched"] = dict(tokens=toks, first=first)
    del sched, params
    gc.collect()
    torch.cuda.empty_cache()
    return refs


def rsplit_rank(mesh, spawned: float, what: str, ref: dict,
                device_type: str) -> dict:
    """Phase 16 on one rank (``sharded_recurrent``): for a recurrent
    family, the sharded init (its card memory right after it), a greedy
    ``generate`` through ``ServeEngine(mesh=)`` with the launch counts
    (and B14's ``lse`` / ``start`` counts) set to 0 just before and read
    just after, then the single-card tokens teacher-forced with every
    B14 / B15 launch held to its plain version on the rank's own inputs
    (``held_calls``), its prefill and decode steps timed (recurrentgemma
    with ``fan_in_qk``, as the single card); for ``"sched"``,
    qwen3-0.6b's requests through ``ContinuousBatchingEngine`` on the
    rank's pieces, launches counted around the run, each request's first
    and last token's time."""
    faulthandler.enable(all_threads=True)
    import gc
    import torch
    import torch.distributed as dist
    from repro_torch.dist.collective_ops import batch_rows
    from repro_torch.kernels import decode_attention as kda
    from repro_torch.kernels import ops
    from repro_torch.models.layers import init_params
    from repro_torch.serving import ServeEngine
    from repro_torch.training.train_loop import param_shardings
    cuda = device_type == "cuda"
    device = (torch.device("cuda", torch.cuda.current_device()) if cuda
              else torch.device(device_type))
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    allocated = torch.cuda.memory_allocated if cuda else (lambda: 0)
    t_all = time.perf_counter()
    out = {"rank": dist.get_rank(), "start": time.time() - spawned,
           "coords": {a: mesh.get_local_rank(a)
                      for a in mesh.mesh_dim_names}}
    if what == "sched":
        from repro_torch.configs import get_arch
        from repro_torch.models import build_model
        cfg = get_arch(SCHED16["arch"]).with_(num_layers=SCHED16["layers"])
        model = build_model(cfg)
    else:
        cfg, model, tokens = rsplit_model(torch, what, device, ref["layers"])
    sync()
    base = allocated()
    params = init_params(model.param_defs(),
                         torch.Generator(device).manual_seed(0), device,
                         shardings=param_shardings(mesh, model))
    sync()
    out["held"] = allocated() - base
    if RSPLIT.get(what, {}).get("fan_in"):
        params = fan_in_qk(params)
    if what == "sched":
        from repro_torch.serving.scheduler import ContinuousBatchingEngine
        eng = ServeEngine(model, max_len=RSCHED["max_len"], device=device,
                          mesh=mesh)
        p, _ = eng.prepare(params)
        del params
        stamps = {}

        def seen(uid, toks, first):
            stamps.setdefault(uid, [time.perf_counter(), 0, 0])
            stamps[uid][1] = time.perf_counter()
            stamps[uid][2] += len(toks)
        sched = ContinuousBatchingEngine(eng.model, p,
                                         slots=RSCHED["slots"],
                                         max_len=RSCHED["max_len"],
                                         device=device, on_token=seen)
        reqs = sched16_requests(cfg.vocab_size)
        zero_launches(ops)
        kda.LSE_LAUNCHES[0] = 0
        sync()
        t0 = time.perf_counter()
        uids = [sched.submit(q, b) for q, b in reqs]
        res = sched.run()
        sync()
        wall = time.perf_counter() - t0
        out.update(tokens=[res[u].tolist() for u in uids],
                   launches={k: n for k, n in ops.LAUNCHES.items() if n},
                   lse=kda.LSE_LAUNCHES[0], chunks=sched.steps_dispatched,
                   chunk=sched.chunk, wall=wall,
                   ttft=[stamps[u][0] - t0 for u in uids],
                   tpot=[(stamps[u][1] - stamps[u][0])
                         / max(stamps[u][2] - 1, 1) for u in uids],
                   seconds=time.perf_counter() - t_all)
        return out
    B, P = tokens.shape
    ML = P + RGEN
    eng = ServeEngine(model, max_len=ML, device=device, mesh=mesh)
    p, _ = eng.prepare(params)
    del params
    zero_launches(ops)
    kda.LSE_LAUNCHES[0] = kda.START_LAUNCHES[0] = 0
    sync()
    t0 = time.perf_counter()
    toks = eng.generate(p, tokens, RGEN)
    sync()
    out.update(wall=time.perf_counter() - t0, toks=toks.cpu().numpy(),
               launches={k: n for k, n in ops.LAUNCHES.items() if n},
               lse=kda.LSE_LAUNCHES[0], start_n=kda.START_LAUNCHES[0])
    rows = batch_rows(mesh, B)
    want = ref["out"].to(device)[rows]
    net = eng.model
    rec = {}

    def teacher_forced():
        t0 = time.perf_counter()
        logits, cache = net.prefill(p, tokens[rows], ML)
        sync()
        rec["prefill"] = time.perf_counter() - t0
        kept = [logits[:, 0, :cfg.vocab_size].float().cpu()]
        t0 = time.perf_counter()
        for t in range(RGEN - 1):
            logits, cache = net.decode_step(p, cache, want[:, t:t + 1], P + t)
            kept.append(logits[:, 0, :cfg.vocab_size].float().cpu())
        sync()
        rec["step"] = (time.perf_counter() - t0) / (RGEN - 1)
        rec["tf"] = torch.stack(kept, 1)
    calls, err, scale = held_calls(torch, teacher_forced)
    lo, hi = rows.start, rows.stop
    out.update(calls=calls, err=err, scale=scale, rows=(lo, hi),
               dl=float((rec["tf"] - ref["tf"][lo:hi]).abs().max()),
               prefill=rec["prefill"], step=rec["step"],
               seconds=time.perf_counter() - t_all)
    del eng, p, rec
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def sharded_recurrent(torch, device, flush) -> dict:
    """Phase 16: sharded serving of the recurrent families and of the zoo
    under the sharded scheduler, every rank a spawned process on this card
    under gloo, the three meshes side by side (RSPLIT, SCHED16): (a)
    recurrentgemma-9b cut to one period at full width on (1, 2), the
    window's edge inside rank 0's full segment (B14 ``start=``); (b)
    rwkv6-7b on (1, 2) at the depth its one-ulp spread picks; (c)
    qwen3-0.6b (SCHED16's layers) under ``ContinuousBatchingEngine`` on
    (2, 2). First B14's ``start=`` alone (``check_decode_start``).

    Gates, each on every rank: (a, b) the sharded init's card memory at
    most ZSPLIT_MEM of the one-card params'; a generate's launches those
    of one card (recurrentgemma: one B15 a prefill, one B14 a step, every
    B14 with ``lse`` and ``start``; rwkv6: none); every B14 / B15 launch of
    the teacher-forced run within one bf16 ulp of its plain version on the
    rank's own inputs (``held_calls``); the teacher-forced logits of every
    generated position within TF_LOGIT_TOL of the single card's; greedy
    tokens equal up to each row's first top-2 margin below TF_MARGIN. (c)
    each request's tokens equal to the one-card scheduler's up to its first
    top-2 margin below TF_MARGIN, every rank's tokens alike, the launches
    a B15 a layer a prefill and a B14 a layer a decode step, every B14
    with ``lse``. Printed: tok/s, TTFT and TPOT (gloo, host-staged), the
    wall a prefill and a decode step a rank."""
    import concurrent.futures
    from repro_torch.launch.mesh import run_ranks
    check_decode_start(torch, device, flush)
    refs = rsplit_single(torch, device)
    jobs = {arch: R["mesh"] for arch, R in RSPLIT.items()}
    jobs["sched"] = SCHED16["mesh"]

    def spawn(what, mesh):
        t0 = time.perf_counter()
        ranks = run_ranks(rsplit_rank, *mesh, device=device.type,
                          backend="gloo",
                          args=(time.time(), what, refs[what], device.type),
                          threads=1, timeout=600)
        return ranks, time.perf_counter() - t0
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futs = {w: pool.submit(spawn, w, m) for w, m in jobs.items()}
        done = {w: f.result() for w, f in futs.items()}
    failed = []
    for what, (ranks, took) in done.items():
        log(f"[rsplit] {what} on mesh {jobs[what]}: {len(ranks)} ranks in "
            f"{took:.1f}s, beside the other meshes' (rank 0 reached the "
            f"card after {ranks[0]['start']:.1f}s)")
        try:
            if what == "sched":
                sched16_gates(torch, ranks, refs["sched"])
            else:
                rsplit_gates(torch, what, jobs[what], ranks, refs[what])
        except AssertionError as e:      # every mesh's gates are read
            log(f"[rsplit] FAILED: {e}")
            failed.append(str(e))
    if failed:
        raise AssertionError("phase 16: " + "; ".join(failed))


def rsplit_gates(torch, arch, mesh, ranks, ref) -> None:
    """Phase 16's gates of a recurrent family (``sharded_recurrent``)."""
    cfg, model, _ = rsplit_model(torch, arch, "cpu", ref["layers"])
    want = expected_launches(model, RGEN)
    want = {k: n for k, n in want.items() if n}
    n_b14 = want.get("decode_attention", 0)
    for rk in ranks:
        tag = f"{arch} {mesh} rank {rk['rank']}"
        share = rk["held"] / ref["param_bytes"]
        if not share <= ZSPLIT_MEM:
            raise AssertionError(f"{tag}: holds {share:.3f} of the one-card "
                                 "params after the sharded init")
        if rk["launches"] != want or rk["lse"] != n_b14 or \
                rk["start_n"] != n_b14:
            raise AssertionError(f"{tag}: launches {rk['launches']}, lse "
                                 f"{rk['lse']}, start {rk['start_n']}; "
                                 f"expected {want}, all B14 with both")
        hwant = want.get("flash_attention", 0) + n_b14 // RGEN * (RGEN - 1)
        if rk["calls"] != hwant:
            raise AssertionError(f"{tag}: {rk['calls']} launches held, "
                                 f"expected {hwant}")
        lo, hi = rk["rows"]
        single = ref["out"].numpy()[lo:hi]
        same = [bool(np.array_equal(rk["toks"][lo:hi][b, :f],
                                    single[b, :f]))
                for b, f in enumerate(ref["first"][lo:hi])]
        if not all(same) or not rk["dl"] <= TF_LOGIT_TOL:
            raise AssertionError(f"{tag}: tokens equal up to small margins "
                                 f"{same}; teacher-forced logits "
                                 f"{rk['dl']:.3e}")
    r = ranks[0]
    held = max(rk["held"] for rk in ranks)
    log(f"[rsplit] {arch} {mesh}: {cfg.num_layers} layers {model.kinds} at "
        f"full width; init: rank memory {held / 2**30:.3f} GiB = "
        f"{held / ref['param_bytes']:.3f} of the one-card params "
        f"({ref['param_bytes'] / 2**30:.3f} GiB; gate {ZSPLIT_MEM}); "
        f"launches a rank a generate {r['launches']} (B14 with lse "
        f"{r['lse']}, with start {r['start_n']}); {r['calls']} B14 / B15 "
        f"launches held to plain (max |err| "
        f"{max(rk['err'] for rk in ranks):.3e}, max |out| "
        f"{max(rk['scale'] for rk in ranks):.3e}); teacher-forced logits of "
        f"every generated position vs single card "
        f"{max(rk['dl'] for rk in ranks):.3e} (tol {TF_LOGIT_TOL}); greedy "
        f"tokens equal up to first margins < {TF_MARGIN} (first small "
        f"margins {ref['first']}); rank 0 (gloo, host-staged): generate "
        f"{r['wall']:.2f} s, prefill {r['prefill']:.2f} s, a decode step "
        f"{r['step'] * 1e3:.1f} ms, {r['seconds']:.1f} s in all")


def sched16_gates(torch, ranks, ref) -> None:
    """Phase 16 (c)'s gates (``sharded_recurrent``)."""
    n_req = RSCHED["requests"]
    layers = SCHED16["layers"]
    for rk in ranks:
        tag = f"sched {SCHED16['mesh']} rank {rk['rank']}"
        want = {"flash_attention": layers * n_req,
                "decode_attention": layers * rk["chunks"] * rk["chunk"]}
        if rk["launches"] != want or rk["lse"] != want["decode_attention"]:
            raise AssertionError(f"{tag}: launches {rk['launches']}, lse "
                                 f"{rk['lse']}; expected {want}")
        for i, (got, single, f) in enumerate(zip(rk["tokens"], ref["tokens"],
                                                 ref["first"])):
            if len(got) != len(single) or got[:f] != list(single[:f]):
                raise AssertionError(f"{tag}: request {i} differs from the "
                                     f"one-card scheduler before its first "
                                     f"small margin ({f})")
        if rk["tokens"] != ranks[0]["tokens"]:
            raise AssertionError(f"{tag}: tokens differ from rank 0's")
    r = ranks[0]
    toks = sum(len(t) for t in r["tokens"])
    same = sum(list(a) == list(b) for a, b in zip(r["tokens"], ref["tokens"]))
    ttft, tpot = sorted(r["ttft"]), sorted(r["tpot"])
    log(f"[rsplit] {SCHED16['arch']} ({layers} of 28 layers, full width) "
        f"under the sharded scheduler on {SCHED16['mesh']}: {RSCHED['slots']}"
        f" slots, {n_req} requests (prompts {RSCHED['prompt']}, budgets "
        f"{RSCHED['budget']}); {same} of {n_req} requests' tokens equal the "
        f"one-card scheduler's, all up to their first top-2 margin < "
        f"{TF_MARGIN}, every rank alike; launches a rank {r['launches']} "
        f"over {r['chunks']} chunks, every B14 with lse; gloo, host-staged: "
        f"{toks} tokens in {r['wall']:.2f} s ({toks / r['wall']:.1f} tok/s), "
        f"TTFT p50 {ttft[len(ttft) // 2] * 1e3:.1f} ms p90 "
        f"{ttft[int(len(ttft) * 0.9)] * 1e3:.1f} ms, TPOT p50 "
        f"{tpot[len(tpot) // 2] * 1e3:.1f} ms; rank 0 "
        f"{r['seconds']:.1f} s in all")


def tp17_model(arch):
    """Phase 17's (cfg, model) of ``arch`` (TP17): full width, the "tp"
    layout, TP17's depth."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    full = get_arch(arch)
    R = TP17[arch]
    cfg = full.with_(layout="tp", num_layers=R.get("layers", full.num_layers),
                     **{k: R[k] for k in ("enc_layers",) if k in R})
    return cfg, build_model(cfg)


def tp17_batch(torch, cfg, arch, device) -> dict:
    """Phase 17's batch of ``arch``: tokens (the labels too) and an
    encoder-decoder's frames or a VLM's patch embeddings, seed 1."""
    R = TP17[arch]
    g = np.random.default_rng(1)
    toks = torch.as_tensor(g.integers(0, cfg.vocab_size,
                                      (R["batch"], R["seq"]))).to(device)
    out = {"tokens": toks, "labels": toks}
    if cfg.encdec:
        out["frames"] = torch.as_tensor(g.standard_normal(
            (R["batch"], R["frames"], cfg.d_model), np.float32)).to(device)
    if cfg.num_patches:
        out["patch_embeds"] = torch.as_tensor(g.standard_normal(
            (R["batch"], cfg.num_patches, cfg.d_model), np.float32)
        ).to(device)
    return out


def tp17_params(torch, model, arch, device):
    """Seed-0 weights from a generator on ``device`` (as ``init_sharded``
    draws the ranks' pieces), wq / wk at the fan-in scale where TP17
    asks."""
    params = model.init(torch.Generator(device).manual_seed(0), device)
    return fan_in_qk(params) if TP17[arch].get("fan_in") else params


def diff_stats(a, b=None, chunk: int = 1 << 26) -> tuple[float, float]:
    """(max |a - b|, the sum of (a - b)^2), of a alone without ``b``, in
    float32, ``chunk`` entries at a time: a whole float32 copy of a 1
    B-entry leaf would not fit beside phase 17's ranks. NaN for both
    where an entry of a or b is not finite."""
    a = a.reshape(-1)
    b = None if b is None else b.reshape(-1)
    most, sq = 0.0, 0.0
    for i in range(0, a.numel(), chunk):
        d = a[i:i + chunk].float()
        if b is not None:
            d = d - b[i:i + chunk].float()
        if not bool(d.isfinite().all()):
            return math.nan, math.nan
        most = max(most, d.abs().max().item())
        sq += d.square().sum().item()
    return most, sq


def tp17_gap(a, b) -> tuple[float, float]:
    """(max |a - b| over b's largest entry, ||a - b|| over ||b||)."""
    most, sq = diff_stats(a, b)
    top, norm = diff_stats(b)
    return most / max(top, 1e-30), math.sqrt(sq / max(norm, 1e-300))


def ulp_up(torch, x, gen):
    """``x`` with half its entries (drawn from ``gen``) one ulp up in
    magnitude."""
    bits = torch.int16 if x.element_size() == 2 else torch.int32
    bump = (torch.rand(x.shape, generator=gen, device=x.device)
            < 0.5).to(bits)
    return (x.view(bits) + bump).view(x.dtype)


def tp17_reference(torch, model, arch, device, sync) -> tuple:
    """One model's one-device step on this rank's card: (loss, seconds for
    ``value_and_grad`` of ``model.loss``, whole params, gradient leaves)."""
    from repro_torch.training.train_loop import value_and_grad
    from repro_torch.training.tree import leaves
    batch = tp17_batch(torch, model.cfg, arch, device)
    params = tp17_params(torch, model, arch, device)
    sync()
    t0 = time.perf_counter()
    loss, grads = value_and_grad(model.loss, params, batch)
    sync()
    return float(loss), time.perf_counter() - t0, params, leaves(grads)


def tp17_spreads(torch, model, arch, device, params, loss, grads) -> dict:
    """The one-ulp spreads of a one-device step: the most the loss, and
    each leaf's gradients (of the leaf's largest entry, and in norm of its
    norm), move over TP17_NUDGES' steps, each with half of every param's
    entries one ulp up."""
    from repro_torch.training.train_loop import value_and_grad
    from repro_torch.training.tree import leaves, unflatten
    batch = tp17_batch(torch, model.cfg, arch, device)
    moves, gaps = [], []
    for seed in TP17_NUDGES:
        gen = torch.Generator(device).manual_seed(seed)
        moved = unflatten(params, [ulp_up(torch, x, gen)
                                   for x in leaves(params)])
        loss2, grads2 = value_and_grad(model.loss, moved, batch)
        moves.append(abs(float(loss2) - loss))
        gaps.append([tp17_gap(a, b) for a, b in zip(leaves(grads2), grads)])
        del moved, grads2
    # numpy's max: a NaN stays a NaN
    most = np.max(np.array(gaps), axis=0)
    return dict(spread_loss=float(np.max(moves)),
                spreads=most[:, 0].tolist(), norm_spreads=most[:, 1].tolist())


def tp17_held(model) -> int:
    """One card's bytes of ``model``'s params and float32 moments under
    TP17_OPT_KW's optimizer."""
    from repro_torch.models.layers import param_bytes
    from repro_torch.training.tree import leaves
    n = sum(math.prod(d.shape) for d in leaves(model.param_defs()))
    moments = 2 if TP17_OPT_KW["name"] == "adamw" else 1
    return param_bytes(model.param_defs()) + 4 * moments * n


def tp17_rank(mesh, spawned: float, device_type: str) -> dict:
    """Phase 17 on one rank, for each TP17 model: its one-device step on
    the whole params (rank 0's first and timed, then rank 0's one-ulp
    spreads beside the other ranks' references), the rank's pieces of
    those gradients kept; then the sharded init of the params and moments
    (its card memory right after), ``step.grads`` (the loss and each
    gradient piece's gap to the kept piece, of the whole leaf's largest
    entry; a digest of each piece the ``model`` axis replicates), then one
    full ``jit_train_step``, timed."""
    faulthandler.enable(all_threads=True)
    import gc
    import types
    import torch
    import torch.distributed as dist
    from repro_torch.dist.collective_ops import shard_local
    from repro_torch.training import OptConfig, jit_train_step
    from repro_torch.training.train_loop import (init_sharded,
                                                 param_shardings)
    from repro_torch.training.tree import leaves
    oc = OptConfig(**TP17_OPT_KW)
    cuda = device_type == "cuda"
    device = (torch.device("cuda", torch.cuda.current_device()) if cuda
              else torch.device(device_type))
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    allocated = torch.cuda.memory_allocated if cuda else (lambda: 0)
    peak = torch.cuda.max_memory_allocated if cuda else (lambda: 0)
    free = torch.cuda.empty_cache if cuda else (lambda: None)
    model_dim = list(mesh.mesh_dim_names).index("model")
    first = dist.get_rank() == 0
    out = {"rank": dist.get_rank(), "start": time.time() - spawned}
    for arch in TP17:
        cfg, model = tp17_model(arch)
        p_sh = leaves(param_shardings(mesh, model))
        t_ref = time.perf_counter()
        if first:
            loss1, wall, whole, ref = tp17_reference(torch, model, arch,
                                                     device, sync)
        dist.barrier()
        if first:
            spread = tp17_spreads(torch, model, arch, device, whole, loss1,
                                  ref)
        else:
            loss1, wall, whole, ref = tp17_reference(torch, model, arch,
                                                     device, sync)
            spread = {}
        del whole
        top = [diff_stats(w)[0] for w in ref]
        ref = [shard_local(w, mesh, sh.placements) for w, sh in zip(ref, p_sh)]
        gc.collect()
        free()
        dist.barrier()
        t_ref = time.perf_counter() - t_ref
        batch = tp17_batch(torch, cfg, arch, device)
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        base = allocated()
        params, opt = init_sharded(mesh, model, oc, torch.Generator(
            device).manual_seed(0), device)
        if TP17[arch].get("fan_in"):
            params = fan_in_qk(params)
        sync()
        held = allocated() - base
        step = jit_train_step(mesh, model, types.SimpleNamespace(
            grad_accum=1, zero1=True), oc, batch)
        t0 = time.perf_counter()
        loss, grads = step.grads(params, batch)
        sync()
        grads_wall = time.perf_counter() - t0
        gaps, sq, split, same = [], [], [], []
        for g, w, most, sh in zip(leaves(grads), ref, top, p_sh):
            d_most, d_sq = diff_stats(g.to_local(), w)
            gaps.append(d_most / max(most, 1e-30))
            sq.append((d_sq, diff_stats(w)[1]))
            split.append(sh.placements[model_dim].is_shard())
            if not split[-1]:
                same.append(digest(g))
        del grads, ref
        t0 = time.perf_counter()
        _, _, met = step(params, opt, batch, 1)
        sync()
        out[arch] = dict(loss=float(loss), gaps=gaps, sq=sq, split=split,
                         replicated=same,
                         peak=peak(), held=held, grads_wall=grads_wall,
                         step_wall=time.perf_counter() - t0,
                         step_loss=float(met["loss"]), ref_loss=loss1,
                         ref_wall=wall, ref_s=t_ref, **spread)
        del params, opt, step, met
        gc.collect()
        free()
    return out


def tp_train_zoo(torch, device) -> None:
    """Phase 17: tensor-parallel training of the zoo (TP17) on TP17_MESH's
    ranks, spawned processes on this card under gloo (every collective
    staged through host memory), each rank holding its pieces of the
    one-device step's gradients, which it computes itself first (so no
    process holds a whole model's gradients beside the ranks' steps).

    Gates, each model on every rank: the sharded loss within TP17_SPREAD
    times the one-device loss's one-ulp spread of it, each gradient leaf
    within TP17_SPREAD times its own one-ulp spreads (of the leaf's
    largest entry, and in norm of its norm, the pieces' squares summed
    over the ranks that split it), every leaf's spread in norm below
    TP17_MAX_SPREAD (the leaves whose spread of the largest entry reaches
    it are named, with their numbers); the loss and every
    gradient piece the ``model`` axis replicates bitwise alike on every
    rank; a rank's card memory right after the sharded init of params and
    moments at most TP17_MEM of one card's; the full step's loss the
    ``grads`` loss. Printed beside them: the spreads, a rank's peak card
    memory, its seconds for the gradients and a step (host-staged), one
    device's for its gradients."""
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.training.train_loop import _paths
    t0 = time.perf_counter()
    ranks = run_ranks(tp17_rank, *TP17_MESH, device=device.type,
                      backend="gloo", args=(time.time(), device.type),
                      threads=1, timeout=600)
    took = time.perf_counter() - t0
    log(f"[tp17] {len(ranks)} ranks on mesh {TP17_MESH} in {took:.1f}s "
        f"(rank 0 reached the card after {ranks[0]['start']:.1f}s)")
    failed = []
    for arch in TP17:
        cfg, model = tp17_model(arch)
        rk = [r[arch] for r in ranks]
        ref = rk[0]
        tol_loss = TP17_SPREAD * max(ref["spread_loss"], 1e-6)
        spreads = ref["spreads"]
        dl = float(np.max([abs(r["loss"] - r["ref_loss"]) for r in rk]))
        # numpy throughout: a NaN (a gradient not finite) fails its gate
        spreads = np.array(spreads)
        nspreads = np.array(ref["norm_spreads"])
        gaps = np.max(np.array([r["gaps"] for r in rk]), axis=0)
        sq = np.array([r["sq"] for r in rk])      # (ranks, leaves, 2)
        ngaps = np.where(
            ref["split"],
            np.sqrt(sq[:, :, 0].sum(0) / np.maximum(sq[:, :, 1].sum(0),
                                                    1e-300)),
            np.max(np.sqrt(sq[:, :, 0] / np.maximum(sq[:, :, 1], 1e-300)),
                   axis=0))
        # the leaf nearest its gate: the largest gap over twice its spread
        worst = int(np.nanargmax(gaps / np.maximum(TP17_SPREAD * spreads,
                                                   1e-30)))
        nworst = int(np.nanargmax(ngaps / np.maximum(
            TP17_SPREAD * nspreads, 1e-30)))
        grads_ok = bool(np.all(gaps <= TP17_SPREAD * spreads)
                        and np.all(ngaps <= TP17_SPREAD * nspreads))
        chaotic = not np.max(nspreads) < TP17_MAX_SPREAD
        names = _paths(model.param_defs())
        wild = "; ".join(
            f"{names[i]} {spreads[i]:.3e} / {gaps[i]:.3e}, in norm "
            f"{nspreads[i]:.3e} / {ngaps[i]:.3e}"
            for i in range(len(gaps)) if spreads[i] >= TP17_MAX_SPREAD)
        one = tp17_held(model)
        share = max(r["held"] for r in rk) / one
        alike = all(r["loss"] == rk[0]["loss"]
                    and r["replicated"] == rk[0]["replicated"] for r in rk)
        same_ref = all(r["ref_loss"] == ref["ref_loss"] for r in rk)
        same_step = all(abs(r["step_loss"] - r["loss"]) <= tol_loss
                        for r in rk)
        ok = (dl <= tol_loss and grads_ok and not chaotic and alike
              and same_step and share <= TP17_MEM)
        ordered, nordered = np.sort(spreads), np.sort(nspreads)
        R = TP17[arch]
        log(f"[tp17] {arch} ({cfg.num_layers} layers, full width, bf16, B="
            f"{R['batch']} S={R['seq']}): loss {rk[0]['loss']:.6f} vs one "
            f"device {ref['ref_loss']:.6f} (|d| {dl:.3e}, one-ulp spread "
            f"{ref['spread_loss']:.3e}, tol {tol_loss:.3e}; the ranks' "
            f"one-device losses bitwise alike: {same_ref}); each of "
            f"{len(gaps)} gradient leaves within {TP17_SPREAD:g}x its own "
            f"one-ulp spreads: {grads_ok} (nearest its gate: "
            f"{names[worst]}, {gaps[worst]:.3e} of its max, spread "
            f"{spreads[worst]:.3e}; in norm {names[nworst]}, "
            f"{ngaps[nworst]:.3e} of its norm, spread "
            f"{nspreads[nworst]:.3e}; the largest gaps {max(gaps):.3e}, in "
            f"norm {max(ngaps):.3e}); the leaves' spreads of the max min "
            f"{ordered[0]:.3e} median {ordered[len(ordered) // 2]:.3e} max "
            f"{ordered[-1]:.3e}, in norm min {nordered[0]:.3e} median "
            f"{nordered[len(nordered) // 2]:.3e} max {nordered[-1]:.3e} "
            f"(gate < {TP17_MAX_SPREAD:g}); spread of the max at least "
            f"{TP17_MAX_SPREAD:g} (spread / gap): {wild or 'none'}; "
            f"replicated pieces and loss bitwise across ranks: {alike}; a "
            f"full step's "
            f"loss within tol: {same_step} (bitwise: "
            f"{all(r['step_loss'] == r['loss'] for r in rk)}); rank memory "
            f"after the sharded init {share:.3f} of one device's params "
            f"and moments ({one / 2**30:.2f} GiB; gate {TP17_MEM}), a "
            f"rank's peak {max(r['peak'] for r in rk) / 2**30:.2f} GiB; "
            f"rank 0: gradients {rk[0]['grads_wall']:.2f} s, a step "
            f"{rk[0]['step_wall']:.2f} s (gloo, host-staged); one device's "
            f"gradients {ref['ref_wall']:.2f} s (the references "
            f"{ref['ref_s']:.1f} s)" + ("" if ok else " FAILED"))
        if not ok:
            failed.append(arch)
    if failed:
        raise AssertionError(f"phase 17: {failed} failed their gates")


def dryrun_cmd(*args) -> list:
    return [sys.executable, "-m", "repro_torch.launch.dryrun", "--out",
            str(DRY14_OUT), "--force", *args]


def start_dryrun(cmds: list) -> list:
    """Start each dry-run command as its own process (a fake group is a
    process's own), one torch thread each; their output to files under
    DRY14_OUT. Returns [(name, Popen, log path, start)]."""
    import os
    DRY14_OUT.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    out = []
    for name, cmd in cmds:
        path = DRY14_OUT / f"{name}.log"
        with open(path, "w") as f:
            proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=f,
                                    stderr=subprocess.STDOUT)
        CHILDREN.append(proc)
        out.append((name, proc, path, time.perf_counter()))
    return out


def stop_children() -> None:
    """End every process this script started that still runs."""
    for proc in CHILDREN:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def finish_dryrun(procs: list, timeout: float = 600) -> None:
    """Wait for the dry-run processes; any that fails (a cell in error)
    fails the phase, its log printed."""
    for name, proc, path, t0 in procs:
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            raise AssertionError(f"dry run {name}: over {timeout}s")
        text = path.read_text()
        log(f"[dryrun] {name}: exit {rc}, "
            f"{time.perf_counter() - t0:.1f}s from its start; "
            + " | ".join(ln for ln in text.splitlines()
                         if ln.startswith(("[OK", "[N", "[ERR", "done"))))
        if rc != 0:
            raise AssertionError(f"dry run {name} failed:\n{text[-3000:]}")


def dryrun_long():
    """The grid's two train_4k traces (the longest: ~1 min of one host
    core each on the card's host), started before phase 10 so they run
    beside the card-bound phases."""
    return start_dryrun([
        (f"grid-train-{m}", dryrun_cmd("--arch", DRY14_GRID, "--shape",
                                        "train_4k", "--mesh", m))
        for m in ("single", "multi")])


def _kinds(items) -> dict:
    """{kind: (count, bytes)} of (kind, bytes) pairs."""
    out: dict = {}
    for kind, nbytes in items:
        n, b = out.get(kind, (0, 0))
        if nbytes is None:
            raise AssertionError(f"a {kind} without its bytes")
        out[kind] = (n + 1, b + nbytes)
    return out


def dryrun_phase(torch, measured: dict, long_procs: list) -> None:
    """Phase 14 (the module docstring): the gate traces and the rest of
    the grid as processes of their own, all at once; the gates against
    phase 13's rank 0 (``measured``); the grid's records printed."""
    procs = []
    for mesh in measured:
        for what, (arch, shape, _, extra) in DRY14_GATES.items():
            procs.append((f"{what}-{mesh[0]}x{mesh[1]}", dryrun_cmd(
                "--arch", arch, "--shape", shape, "--mesh-shape",
                f"{mesh[0]},{mesh[1]}", *extra)))
    procs.append(("grid-serve", dryrun_cmd(
        "--arch", DRY14_GRID, "--shape", "prefill_32k,decode_32k,long_500k",
        "--mesh", "both")))
    finish_dryrun(start_dryrun(procs) + long_procs)
    for mesh, m13 in measured.items():
        tag = f"mesh{mesh[0]}x{mesh[1]}"
        for what, (arch, _, shape, _) in DRY14_GATES.items():
            rec = json.loads((DRY14_OUT / f"{arch}__{shape}__{tag}.json")
                             .read_text())
            if rec["status"] != "ok":
                raise AssertionError(f"dry run {arch} {tag}: {rec}")
            card = m13[what]
            mem = rec["memory"]
            held = mem["held"]
            got_held = (held["params"] + held["moments"] + held["count"]
                        if what == "train" else
                        held["params"] + held["cache"])
            want_held = (card["held"] if what == "train" else
                         card["held"]["params"] + card["held"]["cache"])
            colls = {}
            for c in rec["collectives"].values():
                n, b = colls.get(c["kind"], (0, 0))
                colls[c["kind"]] = (n + c["count"], b + c["bytes"])
            want_colls = _kinds(card["colls"])
            dry_mem = mem["argument_bytes"] + mem["temp_bytes"]
            card_mem = want_held + card["batch"] + card["peak"]
            gap = (dry_mem - card_mem) / card_mem
            log(f"[dryrun] {what} {arch} on {mesh}: aten FLOPs "
                f"{rec['flops_per_chip']['aten']} traced vs "
                f"{card['flops']} on gloo rank 0; held bytes "
                f"{got_held} vs {want_held}; collectives {colls} vs "
                f"{want_colls}; argument + temp {dry_mem / 2**20:.1f} MiB "
                f"vs the card's held + batch + peak {card_mem / 2**20:.1f} "
                f"MiB ({gap:+.2%}, gate {DRY14_MEM:.0%}); trace "
                f"{rec['trace_s']}s on {rec['trace_device']}")
            if rec["flops_per_chip"]["aten"] != card["flops"]:
                raise AssertionError(f"{what} {mesh}: aten FLOPs differ")
            if got_held != want_held:
                raise AssertionError(f"{what} {mesh}: held bytes differ")
            if colls != want_colls:
                raise AssertionError(f"{what} {mesh}: collectives differ")
            if not abs(gap) <= DRY14_MEM:
                raise AssertionError(f"{what} {mesh}: memory {gap:+.2%}")
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        for tag in ("pod16x16", "pod2x16x16"):
            rec = json.loads((DRY14_OUT / f"{DRY14_GRID}__{shape}__{tag}"
                              f".json").read_text())
            if rec["status"] == "ok":
                r, m = rec["roofline"], rec["memory"]
                log(f"[dryrun] grid {DRY14_GRID} {shape} {tag}: ok, "
                    f"{m['peak_bytes'] / 2**30:.2f} GiB a rank, fits "
                    f"{m['fits']}, bound {r['bound']}, step_s "
                    f"{r['step_s']:.6f} (compute {r['compute_s']:.6f}, "
                    f"memory {r['memory_s']:.6f}, collective "
                    f"{r['collective_s']:.6f}); trace {rec['trace_s']}s")
            elif rec["status"] in ("n/a", "not_ported"):
                log(f"[dryrun] grid {DRY14_GRID} {shape} {tag}: "
                    f"{rec['status']} ({rec['reason'][:80]})")
            else:
                raise AssertionError(f"dry run {shape} {tag}: {rec}")


def main() -> int:
    # a fault in native code prints every thread's Python stack to stderr
    faulthandler.enable(all_threads=True)
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
        f"python {sys.version.split()[0]}; {versions_line()}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"built {len(_build.SIGNATURES)} CUDA sources in "
        f"{time.perf_counter() - t0:.1f}s (into {_build.BUILD})")
    for name, out in _build.BUILD_LOG.items():
        n = sum("Compiling entry function" in ln for ln in out.splitlines())
        tier = (ptxas_attention(out, _build.load(
            "attention").brds_flash_attention_bf16_smem(128, 2))
                if name == "attention" else ptxas_serve_tier(out))
        log(f"  {name}: {n} kernels; the B=8 serve tier: " + "; ".join(tier))

    occupancy(torch, device)
    occupancy_d256(torch, device)
    occupancy_zoo(torch, device)

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    t0 = time.perf_counter()

    def phase(name):
        nonlocal t0
        took = time.perf_counter() - t0
        log(f"[phase] {name}: {took:.1f}s")
        # also on stderr, so the end of stderr alone says how far a run got
        print(f"[phase] {name} done in {took:.1f}s", file=sys.stderr,
              flush=True)
        t0 = time.perf_counter()

    rec = check_kernels(torch, device, flush)
    phase("2 kernels")
    rec.update(check_attention(torch, device, flush))
    check_attention_d256(torch, device, flush)
    check_attention_zoo(torch, device, flush)
    check_decode_lse(torch, device, flush)
    phase("6 attention kernels")
    del flush
    launches, first = serve(torch, device)
    phase("3 serve, captured and host loops")
    launches.update(spec_serve(torch, device, first))
    phase("4 speculative serve")
    launches.update(format_api(torch, device))
    phase("5 format API")
    launches.update(transformer_serve(torch, device))
    phase("7 transformer serve")
    scheduler_serve(torch, device)
    phase("8 scheduler")
    training(torch, device)
    phase("9 training")
    long_procs = dryrun_long()
    recurrent_serve(torch, device)
    phase("10 recurrent families")
    zoo_serve(torch, device)
    phase("11 the rest of the zoo")
    dist_serve(torch, device)
    phase("12 sharded decode")
    measured = sharded_phase(torch, device)
    phase("13 sharded training and split-KV decode")
    dryrun_phase(torch, measured, long_procs)
    phase("14 the production dry run")
    splitkv_zoo(torch, device)
    phase("15 split-KV zoo")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    sharded_recurrent(torch, device, flush)
    del flush
    phase("16 sharded recurrent families and the sharded scheduler")
    tp_train_zoo(torch, device)
    phase("17 tensor-parallel training of the zoo")
    log("[graph] rows: " + json.dumps(GRAPH_ROWS))

    src = {"rb_dual_spmv": ("rb_spmv.cu", "src/repro/kernels/rb_spmv.py:86"),
           "lstm_gates": ("lstm_gates.cu",
                          "src/repro/kernels/lstm_gates.py:70"),
           "fused_brds_lstm_step": ("fused_step.cu",
                                    "src/repro/kernels/fused_step.py:158"),
           "delta_rb_dual_spmv": ("delta_rb_spmv.cu",
                                  "src/repro/kernels/delta_rb_spmv.py:99"),
           "fused_brds_delta_lstm_step": (
               "fused_step.cu", "src/repro/kernels/fused_step.py:220"),
           "rb_dual_parts_q8": ("rb_spmv_q8.cu",
                                "src/repro/kernels/rb_spmv_q8.py:101"),
           "fused_brds_lstm_step_q8": ("fused_step.cu",
                                       "src/repro/kernels/fused_step.py:284"),
           "fused_brds_delta_lstm_step_q8": (
               "fused_step.cu", "src/repro/kernels/fused_step.py:346"),
           "rb_spmv": ("rb_spmv.cu", "src/repro/kernels/rb_spmv.py:45"),
           "rb_spmv_q8": ("rb_spmv_q8.cu",
                          "src/repro/kernels/rb_spmv_q8.py:50"),
           "delta_rb_spmv": ("delta_rb_spmv.cu",
                             "src/repro/kernels/delta_rb_spmv.py:53"),
           "fused_brds_lstm_scan": ("fused_scan.cu",
                                    "src/repro/kernels/fused_step.py:415"),
           "fused_brds_delta_lstm_scan": (
               "fused_scan.cu", "src/repro/kernels/fused_step.py:513"),
           "decode_attention": (
               "attention.cu", "src/repro/kernels/decode_attention.py:57"),
           "flash_attention": (
               "attention.cu", "src/repro/kernels/flash_attention.py:80")}
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
    try:
        code = main()
    finally:
        stop_children()
    sys.exit(code)

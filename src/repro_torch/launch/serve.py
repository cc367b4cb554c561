"""Lockstep serving driver for the paper's LSTMs, dense or BRDS-packed,
with temporal-delta and quantized variants, and for every model of the
zoo, dense or BRDS-pruned:

  python -m repro_torch.launch.serve --arch lstm_ptb --brds
  python -m repro_torch.launch.serve --arch lstm_ptb --brds --delta 0
  python -m repro_torch.launch.serve --arch lstm_ptb --brds --quant int8
  python -m repro_torch.launch.serve --arch lstm_ptb --brds --delta 0 \\
      --quant int8
  python -m repro_torch.launch.serve --arch lstm_ptb --brds --smoke \\
      --device cpu
  python -m repro_torch.launch.serve --arch lstm_ptb --brds \\
      --draft lstm_imdb --draft-brds --spec-k 4
  python -m repro_torch.launch.serve --arch qwen3-0.6b [--brds]
  python -m repro_torch.launch.serve --arch qwen3-0.6b --smoke --device cpu
  python -m repro_torch.launch.serve --arch qwen3-0.6b --draft lstm_ptb \\
      --draft-brds --spec-k 4
  python -m repro_torch.launch.serve --arch lstm_ptb --brds --continuous \\
      --slots 4
  python -m repro_torch.launch.serve --arch lstm_ptb --brds --traffic \\
      --rate 16 --requests 64 --slots 8 --deadline 2.0
  python -m repro_torch.launch.serve --arch recurrentgemma-9b
  python -m repro_torch.launch.serve --arch rwkv6-7b --draft lstm_ptb \\
      --draft-brds
  python -m repro_torch.launch.serve --arch lstm_ptb --brds --scorecard \\
      --metrics metrics.json
  python -m repro_torch.launch.serve --arch granite-moe-1b-a400m \\
      --draft lstm_ptb --draft-brds
  python -m repro_torch.launch.serve --arch seamless-m4t-medium --smoke \\
      --device cpu
  python -m repro_torch.launch.serve --arch llava-next-34b --smoke \\
      --device cpu
  python -m repro_torch.launch.serve --arch lstm_ptb --brds --smoke \\
      --mesh 2,2 --device cpu
  python -m repro_torch.launch.serve --arch lstm_ptb --brds --mesh 1,2 \\
      --dist-backend gloo

Runs on the card unless ``--device cpu`` is given, at the configuration's
full width unless ``--smoke`` narrows it (an LSTM to widths of 128, a
transformer to ``configs.smoke_config``). ``--arch`` takes the LSTM
language models and the zoo's config names (the default is
``qwen3-0.6b``, as the reference's). The encoder-decoder's prompts come
with frame embeddings of (batch, 32, d) and a VLM's with patch embeddings
of (batch, num_patches, d), drawn from the run's generator, as the
reference's ``extra_fn`` draws them (under ``--continuous`` the frames
have the config's ``enc_len`` rows, which the scheduler's slots hold;
``--traffic`` submits no conditioning and refuses the encoder-decoder). A
zoo model's ``--brds`` prunes it with ``transformer_policy(--spar-a,
--spar-b)`` (MLP, experts and RWKV6's channel mix at A; attention, RG-LRU
and RWKV6's time mix at B); ``--delta``, ``--quant`` and ``--scorecard``
are LSTM-only. A packed LSTM (an LSTM draft
too) steps through the single-launch fused kernels (``--fused``, the
default) or the chained ones (``--no-fused``). Prints the generation
rate (median and range of ``RUNS`` timed runs after one warm-up run), the
device it ran on and, after a ``--delta`` run, the fired-column
occupancy.
``--draft ARCH`` decodes by speculative rounds with an LSTM draft of that
configuration (``--draft-brds`` / ``--draft-delta`` / ``--draft-quant``
serve it packed, temporal-delta or quantized) and prints its acceptance.
``--continuous`` serves ``--batch`` ragged requests through the
continuous-batching scheduler (``--slots``, ``--dispatch-depth``);
``--traffic`` drives the scheduler with a seeded Poisson trace
(``--rate``, ``--requests``, ``--deadline``, ``--load-seed``) and prints
the latency figures (TTFT / TPOT percentiles, goodput, drops). ``--trace
FILE`` writes a Chrome trace of the engine and scheduler spans;
``--profile`` prints the device's busy share of any of these runs.
``--metrics FILE`` dumps a metrics snapshot (Prometheus text, or JSON
for a ``.json`` FILE: the run's on-device counters, its rate, spec
acceptance and, under ``--traffic``, the request records), and
``--scorecard`` prints the effective-GOPS scorecard of the timed run
against the card's decode roofline (``obs.scorecard``); the counters ride
the decode only when one of the two asks for them.
``--mesh DATA,MODEL`` serves a packed LSTM (``--brds``) sharded over
DATA × MODEL ranks (``repro_torch.dist``): the gate rows split over MODEL,
the batch (or the scheduler's slots) over DATA where it divides. Every
model of the zoo (the dense GQA transformers, granite-moe and qwen3-moe,
seamless-m4t, llava, recurrentgemma and rwkv6, any of them with
``kv_quant``; ``--brds`` or not) runs tensor-parallel and decodes
split-KV (``dist.tensor_parallel``, ``dist.splitkv``): its projections,
MLP, experts, recurrent mixers (RG-LRU's ``d_rnn``, RWKV6's heads) and
vocabulary over MODEL, its KV cache (and an encoder-decoder's cross
memory) over MODEL along the sequence, its frames or patches over DATA
with the prompts, lockstep or under the scheduler.
Each rank draws every param as ``model.init`` draws it and keeps only its
piece (``layers.init_params(shardings=)``), so no rank holds whole
params. The CLI
spawns the ranks itself (``launch.mesh.run_ranks``) unless it already
runs under ``torchrun``; rank 0 prints. ``--dist-backend`` picks NCCL (one
card a rank, the default on the card) or gloo (any number of ranks, on
the CPU or sharing cards; collectives staged through host memory). It
composes with ``--delta``, ``--quant``, ``--continuous`` and
``--traffic``, implies ``--no-fused`` (sharded decode chains), and refuses
``--draft``, ``--scorecard`` and ``--metrics``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import math
import os
import statistics
import sys
import time

import torch

RUNS = 5   # timed generate runs: host-clock rates spread between runs


def _build_draft(args, vocab: int, max_len: int, device: torch.device):
    """The ``--draft`` DraftModel: an LSTM from ``LSTM_CONFIGS`` rebound to
    ``vocab``, the width of the target's logits (a transformer's padded
    vocabulary), as a language model (a classifier's head is replaced by a
    vocabulary head), with weights from seed 7, prepared (prune, pack,
    delta, quant) by its own ServeEngine."""
    from repro_torch.models import LSTMModel, LSTM_CONFIGS
    from repro_torch.serving import ServeEngine
    from repro_torch.sparse import DeltaGateConfig, QuantConfig, lstm_policy
    from repro_torch.spec import DraftModel
    cfg = LSTM_CONFIGS[args.draft]
    if args.smoke:
        cfg = dataclasses.replace(cfg, input_size=min(cfg.input_size, 128),
                                  hidden=min(cfg.hidden, 128))
    cfg = dataclasses.replace(cfg, vocab_size=vocab, num_classes=0,
                              framewise=False)
    sparsity = None
    if args.draft_brds or args.draft_delta is not None:
        delta = None
        if args.draft_delta is not None:
            delta = DeltaGateConfig(theta_x=args.draft_delta,
                                    theta_h=args.draft_delta)
        quant = QuantConfig(args.draft_quant) if args.draft_quant else None
        sparsity = lstm_policy(args.spar_a if args.draft_brds else 0.0,
                               args.spar_b if args.draft_brds else 0.0,
                               delta=delta, quant=quant)
    deng = ServeEngine(LSTMModel(cfg, fused=args.fused), max_len=max_len,
                       sparsity=sparsity, device=device)
    dparams = deng.model.init(torch.Generator().manual_seed(7), device)
    calib = None
    if args.draft_quant:
        calib = torch.randint(0, vocab, (args.batch, min(args.prompt_len, 32)),
                              generator=torch.Generator().manual_seed(8)
                              ).to(device)
    dparams, report = deng.prepare(dparams, calib=calib)
    if report is not None:
        print("draft BRDS:", report)
    return DraftModel(deng.model, dparams)


def _lstm_target(args, device):
    """(model, params, sparsity) for an LSTM ``--arch``."""
    from repro_torch.models import LSTMModel, LSTM_CONFIGS
    from repro_torch.sparse import DeltaGateConfig, QuantConfig, lstm_policy
    cfg = LSTM_CONFIGS[args.arch]
    if args.smoke:
        cfg = dataclasses.replace(cfg, input_size=min(cfg.input_size, 128),
                                  hidden=min(cfg.hidden, 128))
    model = LSTMModel(cfg, fused=args.fused)
    params = model.init(torch.Generator().manual_seed(args.seed), device)
    sparsity = None
    if args.brds or args.delta is not None:
        delta = None
        if args.delta is not None:
            delta = DeltaGateConfig(
                theta_x=args.delta,
                theta_h=(args.delta_h if args.delta_h is not None
                         else args.delta),
                cap_x=args.occupancy, cap_h=args.occupancy)
        quant = QuantConfig(args.quant) if args.quant else None
        # ratio 0 compiles to an empty weight plan: --delta without --brds
        # serves dense weights with temporal skipping only
        sparsity = lstm_policy(args.spar_a if args.brds else 0.0,
                               args.spar_b if args.brds else 0.0,
                               delta=delta, quant=quant)
    return model, params, sparsity


def _transformer_target(ap, args, device, mesh=None):
    """(model, params, sparsity, extra_fn) for a zoo ``--arch``;
    ``extra_fn(gen, batch, frames=32)`` draws the family's conditioning
    (None for a text-only model). Under ``mesh`` the params are this
    rank's pieces (DTensors laid out by ``training.param_shardings``),
    each drawn as ``model.init`` draws it and cut before the next."""
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.models import build_model
    from repro_torch.sparse import transformer_policy
    if args.delta is not None:
        ap.error("--delta is LSTM-only (temporal sparsity rides the "
                 "recurrent decode cache)")
    if args.quant is not None:
        ap.error("--quant is LSTM-only (quantization rides the packed LSTM "
                 "decode path)")
    if args.scorecard:
        ap.error(f"--scorecard is LSTM-only (its MAC/byte ledger covers the "
                 f"recurrent cell — repro_torch.obs.scorecard), not "
                 f"{args.arch}")
    cfg = smoke_config(args.arch) if args.smoke else get_arch(args.arch)
    if args.traffic and cfg.encdec:
        ap.error(f"--traffic submits prompts without frames, which "
                 f"{args.arch} (an encoder-decoder) needs")
    model = build_model(cfg)
    shardings = None
    if mesh is not None:
        from repro_torch.training.train_loop import param_shardings
        shardings = param_shardings(mesh, model)
    if device.type == "cuda":
        need = rank_param_bytes(model, shardings)
        free = torch.cuda.mem_get_info(device)[0]
        if need > free:
            raise SystemExit(
                f"{args.arch}: this rank's params ({need / 2**30:.1f} GiB) "
                f"do not fit the {free / 2**30:.1f} GiB free on its card")
    t0 = time.perf_counter()
    from repro_torch.models.layers import init_params
    params = init_params(model.param_defs(),
                         torch.Generator().manual_seed(args.seed), device,
                         shardings=shardings)
    _sync(device)
    print(f"init {time.perf_counter() - t0:.2f}s ({cfg.dtype} weights from "
          f"a CPU generator, seed {args.seed}"
          + (", this rank's pieces" if mesh is not None else "") + ")")
    sparsity = (transformer_policy(args.spar_a, args.spar_b) if args.brds
                else None)

    def extra_fn(gen, batch, frames=32):
        rows = frames if cfg.encdec else cfg.num_patches
        if not rows:
            return None
        return torch.randn((batch, rows, cfg.d_model), generator=gen).to(
            device=device, dtype=cfg.torch_dtype)

    return model, params, sparsity, extra_fn


def rank_param_bytes(model, shardings=None) -> int:
    """The bytes of ``model``'s params one rank holds: all of them, or
    under ``shardings`` (``training.param_shardings``) its pieces."""
    from repro_torch.models.layers import param_bytes
    from repro_torch.training.tree import leaves
    defs = model.param_defs()
    if shardings is None:
        return param_bytes(defs)
    total = 0
    for d, sh in zip(leaves(defs), leaves(shardings)):
        n = math.prod(d.shape) * d.dtype.itemsize
        for i, pl in enumerate(sh.placements):
            if pl.is_shard():
                n //= sh.mesh.size(i)
        total += n
    return total


def _no_extra(gen, batch, frames=32):
    """An LSTM's prompts take no conditioning."""
    return None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_span(events) -> float:
    """Seconds the device ran anything: the union of the device events'
    intervals. Kernels overlap under a programmatic dependent launch (a
    dependent's blocks start, and wait, while its producer runs), where a
    sum of their times counts the overlap twice."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation)
    total, end = 0.0, float("-inf")
    for s, t in spans:
        if t > end:
            total += t - max(s, end)
            end = t
    return total / 1e6


def _profile(run, device: torch.device) -> None:
    """Run ``run`` under torch.profiler; print the device time by kernel,
    the device's busy share of the wall time (the profiler's own overhead
    included, so the share reads low) and the device's span (the union of
    its kernels' intervals)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    _sync(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        _sync(device)
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    print(events.table(sort_by="self_device_time_total", row_limit=12))
    # device-side events only: an operator's row repeats its kernels' time
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation) / 1e6
    print(f"profile: wall {wall * 1e3:.3f} ms, device busy "
          f"{busy * 1e3:.3f} ms ({busy / wall:.1%} of wall), device span "
          f"{_device_span(prof.events()) * 1e3:.3f} ms")


def parser() -> argparse.ArgumentParser:
    """The CLI's argument parser."""
    from repro_torch.configs import ARCH_NAMES
    from repro_torch.models import LSTM_CONFIGS

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=sorted(
        k for k, c in LSTM_CONFIGS.items() if c.vocab_size) + ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true",
                    help="LSTM: narrow input and hidden widths to 128; "
                         "transformer: its smoke config (few layers, narrow "
                         "widths, float32)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a "
                         "card unless 'cpu' is given)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--brds", action="store_true",
                    help="row-balanced prune (and, for an LSTM, pack) the "
                         "weights")
    ap.add_argument("--spar-a", type=float, default=0.75,
                    help="sparsity of family A: the LSTM's input weights "
                         "W_x, a transformer's MLP")
    ap.add_argument("--spar-b", type=float, default=0.5,
                    help="sparsity of family B: the LSTM's recurrent "
                         "weights W_h, a transformer's attention")
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "ref", "cuda"),
                    help="kernel backend (packed LSTM decode, attention)")
    ap.add_argument("--delta", type=float, default=None, metavar="THETA",
                    help="serve with temporal-delta sparsity at threshold "
                         "THETA (0 = exact; composes with --brds)")
    ap.add_argument("--delta-h", type=float, default=None,
                    help="recurrent-path threshold (default: --delta)")
    ap.add_argument("--occupancy", type=float, default=None, metavar="CAP",
                    help="cap the fired-column fraction per step")
    ap.add_argument("--quant", default=None, metavar="SCHEME",
                    help="requires --brds: serve quantized packed weights "
                         "('int8' or 'qM.N', e.g. 'q1.11'); activation "
                         "scales are calibrated on a prompt-shaped batch; "
                         "composes with --delta")
    ap.add_argument("--fused", dest="fused", action="store_true",
                    default=True,
                    help="LSTM: force single-launch fused decode kernels "
                         "(the default, on every packed path)")
    ap.add_argument("--no-fused", dest="fused", action="store_false",
                    help="LSTM: force the chained per-kernel decode path "
                         "(gate kernel, then lstm_gates) on every packed "
                         "path: float, --delta, --quant and both")
    ap.add_argument("--draft", default=None, metavar="ARCH",
                    choices=sorted(LSTM_CONFIGS),
                    help="speculative decoding: propose with this LSTM "
                         "configuration rebound to the target's vocabulary; "
                         "greedy output is token for token that of serving "
                         "without it")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="--draft: tokens proposed per speculative round")
    ap.add_argument("--draft-brds", action="store_true",
                    help="row-balanced prune and pack the draft's weights "
                         "(--spar-a/--spar-b ratios)")
    ap.add_argument("--draft-delta", type=float, default=None,
                    metavar="THETA",
                    help="draft with temporal-delta sparsity at THETA")
    ap.add_argument("--draft-quant", default=None, metavar="SCHEME",
                    help="draft with quantized packed weights ('int8' or "
                         "'qM.N'); requires --draft-brds")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=0.0)
    ap.add_argument("--eos-id", type=int, default=-1)
    ap.add_argument("--continuous", action="store_true",
                    help="serve a ragged request stream through the "
                         "continuous-batching scheduler instead of one "
                         "lockstep batch")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--traffic", action="store_true",
                    help="drive the scheduler with a seeded Poisson arrival "
                         "trace (repro_torch.traffic.loadgen) and report "
                         "the latency curve: TTFT/TPOT percentiles, "
                         "goodput, drops. Composes with --brds/--delta/"
                         "--quant; uses --slots and --dispatch-depth")
    ap.add_argument("--rate", type=float, default=8.0,
                    help="--traffic: offered load, requests/second")
    ap.add_argument("--requests", type=int, default=64,
                    help="--traffic: total requests in the trace")
    ap.add_argument("--deadline", type=float, default=None, metavar="SEC",
                    help="--traffic: per-request TTLT deadline; queued "
                         "requests expire and in-slot requests are evicted "
                         "past it (overload shedding)")
    ap.add_argument("--dispatch-depth", type=int, default=2,
                    help="decode chunks kept in flight ahead of the host "
                         "(1 = synchronous harvest-before-dispatch)")
    ap.add_argument("--load-seed", type=int, default=0,
                    help="--traffic: arrival-trace RNG seed (the schedule "
                         "is fully deterministic given the seed)")
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="record a Chrome-trace (Perfetto-loadable JSON) of "
                         "engine/scheduler spans to FILE "
                         "(repro_torch.obs.trace)")
    ap.add_argument("--metrics", default=None, metavar="FILE",
                    help="dump a metrics snapshot to FILE — Prometheus "
                         "text, or JSON when FILE ends in .json "
                         "(repro_torch.obs.metrics)")
    ap.add_argument("--scorecard", action="store_true",
                    help="LSTM only: print the effective-GOPS scorecard — "
                         "harvested on-device counters against the decode "
                         "roofline (repro_torch.obs.scorecard)")
    ap.add_argument("--profile", action="store_true",
                    help="run once more under torch.profiler (the generate, "
                         "or the --continuous / --traffic run) and print "
                         "the device time by kernel and the busy share")
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="serve a packed LSTM (--brds) or any model of "
                         "the zoo (tensor-parallel, split-KV), lockstep or "
                         "under the scheduler (--continuous / --traffic), "
                         "sharded over a (data, model) mesh of DATA x MODEL "
                         "ranks, e.g. '2,2' (repro_torch.dist); the CLI "
                         "spawns the ranks unless it runs under torchrun")
    ap.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                    help="--mesh: the process group's backend (default: "
                         "nccl on the card, one card a rank; gloo on the "
                         "CPU, and on the card when asked: ranks may share "
                         "a card, collectives staged through host memory)")
    return ap


def _mesh_shape(ap, args) -> tuple[int, int]:
    """``--mesh``'s (data, model), after the checks it needs."""
    from repro_torch.models import LSTM_CONFIGS
    try:
        d, m = (int(v) for v in args.mesh.split(","))
    except ValueError:
        ap.error(f"--mesh wants 'DATA,MODEL' ints, got {args.mesh!r}")
    if d < 1 or m < 1:
        ap.error(f"--mesh {args.mesh}: sizes must be positive")
    if args.arch not in LSTM_CONFIGS:
        if (args.prompt_len + args.gen) % m:
            ap.error(f"--mesh {args.mesh}: the cache of --prompt-len + --gen "
                     f"= {args.prompt_len + args.gen} positions must split "
                     f"over the {m} ranks of the model axis (split-KV)")
    elif not args.brds:
        ap.error("--mesh on an LSTM requires --brds (sharded decode "
                 "row-shards the packed gate rows — repro_torch.dist)")
    if args.draft is not None:
        ap.error("--draft does not compose with --mesh")
    if args.scorecard or args.metrics is not None:
        ap.error("--scorecard / --metrics read counters that are not "
                 "reduced over a mesh's ranks: serve them without --mesh")
    return d, m


def _serve_rank(mesh, argv):
    """One rank of a ``--mesh`` run: the CLI over ``mesh``; only rank 0
    prints."""
    import torch.distributed as dist
    if dist.get_rank() == 0:
        return main(argv, mesh=mesh)
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
        main(argv, mesh=mesh)


def _launch_mesh(ap, args, argv, data: int, model: int) -> None:
    """Run the CLI on ``data × model`` ranks: in this process under
    torchrun (its environment names the rank), else spawned."""
    import torch.distributed as dist
    from repro_torch.device import resolve_device
    from repro_torch.launch import mesh as M
    device = resolve_device(args.device)
    try:
        backend = M.backend_for(device, data * model, args.dist_backend)
    except ValueError as e:
        ap.error(f"--mesh {args.mesh}: {e}")
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
        try:
            _serve_rank(M.make_mesh((data, model), device=device,
                                    backend=backend), argv)
        finally:
            dist.destroy_process_group()
        return
    threads = max(1, (os.cpu_count() or 1) // (data * model))
    M.run_ranks(_serve_rank, data, model, device=device, backend=backend,
                args=(argv,), threads=threads)


def main(argv=None, mesh=None):
    """The CLI on ``argv`` (``sys.argv[1:]`` when None); ``mesh``: this
    rank's mesh, inside a ``--mesh`` run."""
    from repro_torch.device import resolve_device
    from repro_torch.models import LSTM_CONFIGS
    from repro_torch.serving import ServeEngine, SamplingConfig
    from repro_torch.sparse import set_default_backend

    argv = sys.argv[1:] if argv is None else list(argv)
    ap = parser()
    args = ap.parse_args(argv)
    if args.delta is None and (args.delta_h is not None
                               or args.occupancy is not None):
        ap.error("--delta-h/--occupancy require --delta")
    if args.quant is not None and not args.brds:
        ap.error("--quant requires --brds (quantization rides the packed "
                 "row-balanced weights)")
    if args.draft is None and (args.draft_brds or args.draft_quant
                               or args.draft_delta is not None):
        ap.error("--draft-brds/--draft-delta/--draft-quant require --draft")
    if args.draft_quant and not args.draft_brds:
        ap.error("--draft-quant requires --draft-brds")
    if args.mesh is None and args.dist_backend is not None:
        ap.error("--dist-backend requires --mesh")
    if args.mesh is not None:
        data, model_size = _mesh_shape(ap, args)
        if mesh is None:
            return _launch_mesh(ap, args, argv, data, model_size)

    device = resolve_device(args.device)
    lead = True      # the rank that saves the trace
    if mesh is not None:
        import torch.distributed as dist
        from repro_torch.launch.mesh import rank_device
        device = rank_device(device, dist.get_rank())
        lead = dist.get_rank() == 0
        staged = dist.get_backend() == "gloo" and device.type == "cuda"
        print(f"mesh: data={data} model={model_size} over "
              f"{data * model_size} ranks, {dist.get_backend()}"
              + (" (collectives staged through host memory)" if staged
                 else ""))
    set_default_backend(args.backend)
    if args.trace:
        from repro_torch.obs import trace as obs_trace
        obs_trace.enable()
    extra_fn = _no_extra
    if args.arch in LSTM_CONFIGS:
        model, params, sparsity = _lstm_target(args, device)
    else:
        model, params, sparsity, extra_fn = _transformer_target(
            ap, args, device, mesh)
    cfg = model.cfg
    print(f"arch={cfg.name} params={model.param_count() / 1e6:.1f}M "
          f"device={device}")
    eng = ServeEngine(model, max_len=args.prompt_len + args.gen,
                      sparsity=sparsity, device=device, mesh=mesh)
    calib = None
    if args.quant:
        # activation scales from a prompt-shaped batch through the dense
        # params (prepare prunes and packs afterwards)
        calib = torch.randint(0, cfg.vocab_size,
                              (args.batch, min(args.prompt_len, 32)),
                              generator=torch.Generator().manual_seed(
                                  args.seed + 3)).to(device)
    params, report = eng.prepare(params, calib=calib)
    if report is not None:
        print("BRDS:", report)
    gen = torch.Generator().manual_seed(args.seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen).to(device)
    sampling = SamplingConfig(temperature=args.temperature, top_k=args.top_k,
                              top_p=args.top_p, eos_id=args.eos_id)
    draft = None
    if args.draft is not None:
        # the draft's vocabulary is the width of the target's logits
        vocab = getattr(model, "vocab_padded", cfg.vocab_size)
        draft = _build_draft(args, vocab, args.prompt_len + args.gen, device)
        print(f"draft={args.draft} spec_k={args.spec_k}")

    if args.continuous or args.traffic:
        # the scheduler's slots hold cross memories of enc_len rows
        _serve_scheduled(args, eng.model, params, sampling, draft, device,
                         lambda batch: extra_fn(gen, batch, getattr(
                             cfg, "enc_len", 32)))
    else:
        _serve_lockstep(args, eng, params, tokens, sampling, draft, device,
                        extra_fn(gen, args.batch))
    if args.trace and lead:
        obs_trace.save(args.trace)
        print(f"trace: {len(obs_trace.get_tracer().events)} spans to "
              f"{args.trace}")


def _serve_lockstep(args, eng, params, tokens, sampling, draft, device,
                    extra=None):
    """One lockstep batch: ``RUNS`` timed generates after a warm-up."""
    from repro_torch.sparse import occupancy_report

    def run():
        return eng.generate(
            params, tokens, args.gen, extra=extra, sampling=sampling,
            rng=torch.Generator(device).manual_seed(args.seed + 2),
            return_state=True, draft=draft, spec_k=args.spec_k)

    run()   # builds the kernels, captures the decode graph, warms libraries
    dts = []
    for _ in range(RUNS):
        _sync(device)
        t0 = time.perf_counter()
        out, state = run()
        _sync(device)
        dts.append(time.perf_counter() - t0)
    dt = statistics.median(dts)
    toks = args.batch * args.gen
    name = _device_name(device)
    print(f"generated {tuple(out.shape)} in {dt:.4f}s, median of "
          f"{len(dts)} runs ({toks / dt:.1f} tok/s, prefill included; "
          f"range {toks / max(dts):.1f}-{toks / min(dts):.1f} tok/s) "
          f"on {name}")
    spec = None
    if draft is not None:
        drafted, accepted, rounds = (int(state[k].sum()) for k in
                                     ("drafted", "accepted", "rounds"))
        spec = dict(rounds=rounds, drafted=drafted, accepted=accepted,
                    acceptance_rate=accepted / max(drafted, 1))
        print(f"spec: acceptance={accepted / max(drafted, 1):.1%} "
              f"({accepted}/{drafted} drafted over {rounds} rounds)")
    if args.delta is not None:
        occ = occupancy_report(state["cache"],
                               steps=args.prompt_len + args.gen,
                               packed=params if args.brds else None)
        line = (f"delta: occupancy x={occ['occupancy_x']:.1%} "
                f"h={occ['occupancy_h']:.1%}")
        if "ops_reduction" in occ:
            line += f", effective-ops reduction {occ['ops_reduction']:.2f}x"
        print(line)
    counters = None
    if _want_counters(args):
        from repro_torch.obs import counters as obs_counters
        counters = obs_counters.from_state(eng.model, state, steps=args.gen)
    _obs_outputs(args, params, counters, dt, batch=args.batch, device=name,
                 step_sum=(float(args.batch * (args.prompt_len + args.gen))
                           if args.delta is not None else None),
                 spec=spec, extra_gauges={"serve_toks_per_s": toks / dt})
    print("sample ids:", out[0, :16].tolist())
    if args.profile:
        _profile(run, device)


def _device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def _want_counters(args) -> bool:
    """Counters ride the decode only when an obs output asks for them."""
    return args.scorecard or args.metrics is not None


def _obs_outputs(args, params, counters, wall_s, *, batch, device,
                 step_sum=None, records=None, summary=None, spec=None,
                 extra_gauges=None):
    """``--scorecard`` and ``--metrics`` outputs, shared by the lockstep,
    ``--continuous`` and ``--traffic`` paths (``repro_torch.obs``)."""
    if args.scorecard and counters is not None:
        from repro_torch.obs import scorecard as obs_scorecard
        card = obs_scorecard.build(params, counters, wall_s, batch=batch,
                                   step_sum=step_sum)
        print(obs_scorecard.render(card, device))
    if args.metrics:
        from repro_torch.obs import MetricsRegistry
        reg = MetricsRegistry()
        if records is not None:
            reg.absorb_traffic(records, summary)
        reg.absorb_spec(spec)
        reg.absorb_counters(counters)
        for name, val in (extra_gauges or {}).items():
            reg.gauge(name).set(val)
        reg.dump(args.metrics)
        print(f"metrics -> {args.metrics}")


def _run_counters(before: dict | None, after: dict | None) -> dict | None:
    """A scheduler's counters over one run: the counter slots (steps,
    tokens, spec rounds) less their values ``before`` it, the gauges
    (fired columns) as they stand ``after`` it."""
    if after is None:
        return None
    from repro_torch.obs import counters as obs_counters
    return {k: v - before[k] if k in obs_counters.BASE_COUNTERS else v
            for k, v in after.items()}


def _scheduler(args, model, params, sampling, draft, device, clock=None):
    from repro_torch.serving.scheduler import ContinuousBatchingEngine
    return ContinuousBatchingEngine(
        model, params, slots=args.slots,
        max_len=args.prompt_len + args.gen, sampling=sampling,
        dispatch_depth=args.dispatch_depth, draft=draft,
        spec_k=args.spec_k, device=device, counters=_want_counters(args),
        clock=clock)


def _serve_scheduled(args, model, params, sampling, draft, device,
                     extra_fn):
    """``--continuous``: ``--batch`` ragged requests through the
    scheduler, each with ``extra_fn(1)``'s conditioning; ``--traffic``: a
    seeded Poisson trace through it (no conditioning). One
    scheduler serves a warm-up first (it captures the chunk and warms the
    prefill widths: the whole batch, or the trace's first ``--slots``
    requests), then the measured run (and, under ``--profile``, the
    profiled one)."""
    import numpy as np
    vocab = model.cfg.vocab_size
    clock = time.perf_counter
    if getattr(model, "mesh", None) is not None:
        # every rank's admissions and arrivals read rank 0's clock
        from repro_torch.launch.mesh import synced_clock
        clock = synced_clock()
    sched = _scheduler(args, model, params, sampling, draft, device,
                       clock=clock)
    if args.traffic:
        from repro_torch.traffic import (LoadConfig, make_prompts,
                                         poisson_trace, serve_trace)
        short_hi = max(5, args.prompt_len // 4)
        long_hi = max(short_hi + 1, args.prompt_len)
        lc = LoadConfig(rate=args.rate, num_requests=args.requests,
                        prompt_short=(4, short_hi),
                        prompt_long=(short_hi, long_hi),
                        output_lens=(4, args.gen), deadline=args.deadline,
                        seed=args.load_seed)
        trace = poisson_trace(lc)
        prompts = make_prompts(trace, vocab, seed=args.load_seed)
        print(f"traffic: {args.requests} requests at {args.rate:.1f} req/s, "
              f"slots={args.slots} depth={args.dispatch_depth}"
              + (f" deadline={args.deadline}s" if args.deadline else ""))
        warm = min(len(trace), args.slots)
        serve_trace(sched, trace[:warm], prompts[:warm], realtime=False,
                    clock=clock)

        def run():
            return serve_trace(sched, trace, prompts, clock=clock,
                               offered_rps=args.rate)
    else:
        g = np.random.default_rng(args.seed + 1)
        lens = [max(4, args.prompt_len - 3 * i) for i in range(args.batch)]
        prompts = [g.integers(0, vocab, (1, n)) for n in lens]
        extras = [extra_fn(1) for _ in prompts]

        def run():
            for p, e in zip(prompts, extras):
                sched.submit(p, args.gen, extra=e)
            t0 = time.perf_counter()
            results = sched.run()
            _sync(device)
            return results, time.perf_counter() - t0

        run()
    first = sched.steps_dispatched
    before = sched.counters()
    out = run()
    chunks = sched.steps_dispatched - first
    counters = _run_counters(before, sched.counters())
    if args.traffic:
        records, s = out
        print(f"completed={s['completed']} expired={s['expired']} "
              f"rejected={s['rejected']} ({s['tokens']} tokens, "
              f"{s['wall_s']:.2f}s wall, {chunks} chunk dispatches)")
        ms = lambda v: "n/a" if v is None else f"{v:.2f}"
        print(f"TTFT ms: p50={ms(s['p50_ttft_ms'])} "
              f"p90={ms(s['p90_ttft_ms'])} p99={ms(s['p99_ttft_ms'])}")
        print(f"TPOT ms: p50={ms(s['p50_tpot_ms'])} "
              f"p99={ms(s['p99_tpot_ms'])}")
        print(f"goodput: {s['goodput_tps']:.1f} tok/s "
              f"(total {s['toks_per_s']:.1f} tok/s)")
    else:
        results, dt = out
        total = sum(len(v) for v in results.values())
        print(f"served {len(results)} ragged requests ({total} tokens) in "
              f"{dt:.2f}s ({total / dt:.1f} tok/s, {chunks} chunk "
              "dispatches)")
        print("sample ids:", results[min(results)][:16].tolist())
    spec = None
    if draft is not None:
        spec = st = sched.spec_stats()
        print(f"spec: acceptance={st['acceptance_rate']:.1%} "
              f"({st['accepted']}/{st['drafted']} drafted over "
              f"{st['rounds']} rounds)")
    step_sum = (float(np.sum(sched.slot_steps)) if args.delta is not None
                else None)
    if args.traffic:
        _obs_outputs(args, params, counters, s["wall_s"], batch=args.slots,
                     device=_device_name(device), step_sum=step_sum,
                     records=records, summary=s, spec=spec)
    else:
        _obs_outputs(args, params, counters, dt, batch=args.slots,
                     device=_device_name(device), step_sum=step_sum,
                     spec=spec, extra_gauges={"serve_toks_per_s":
                                              total / dt})
    if args.profile:
        _profile(run, device)


if __name__ == "__main__":
    main()

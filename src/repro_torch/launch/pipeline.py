"""Close the paper's accuracy loop: train → prune → retrain → calibrate
→ pack → serve, with perplexity as a tested gate (the port of
``repro/launch/pipeline.py``).

The paper's headline quality claim — dual-ratio (Spar_x, Spar_h) pruning
with retraining costs ≲1.4% PTB perplexity — run end to end on the
synthetic corpora of ``training/data.py`` (CharCorpus as the PTB stand-in,
FrameCorpus for the TIMIT claim), with two invariants:

  quality gate      at the primary (Spar_x, Spar_h) tuple, the retrained
                    model's eval perplexity delta vs the dense baseline
                    must stay under ``--gate`` percent.
  serving parity    the ``ServeEngine.prepare``'d model (prune → pack →
                    calibrate → pad → delta/quant rewiring) must score
                    BITWISE equal to the manually composed deployment at
                    every grid point — the serving stack may change speed,
                    never quality.

Training runs the dense LSTM in plain PyTorch under autograd; every
deployment is scored through the serving step path (``LSTMModel.score``),
which on the card launches the fused step kernels: B3 for fp32, B5 at
Θ > 0, B8 for int8, B9 for int8 at Θ > 0. It emits ``BENCH_pipeline.json``
quality × compression records over a (Spar_x, Spar_h) × {fp32, quant} ×
{Θ=0, Θ>0} grid (schema: ``scripts/check_bench_schema.py``).

``--mesh D,M`` (``PipelineConfig.mesh``) trains both phases, dense and
masked retrain, sharded over a (data, model) mesh through
``training.jit_train_step``: on ``launch.mesh.run_ranks``' spawned ranks,
or on the ``torchrun`` group when there is one. Every rank runs the whole
pipeline; the trained params are gathered whole, and prune, pack and serve
run as without a mesh (rank 0 prints and writes). On one card the ranks
share it under gloo.

  PYTHONPATH=src python -m repro_torch.launch.pipeline --smoke --gate 5
  PYTHONPATH=src python -m repro_torch.launch.pipeline --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.pipeline --corpus frame --smoke
  PYTHONPATH=src python -m repro_torch.launch.pipeline --smoke --mesh 1,2 \
      --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import types
from typing import Any, Callable

import numpy as np
import torch

__all__ = ["PipelineConfig", "PipelineError", "build_task", "train_lstm",
           "evaluate", "prepare_manual", "run_point", "run_pipeline",
           "write_bench", "main"]


class PipelineError(AssertionError):
    """A pipeline invariant (serving parity, quality gate) failed."""


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """One end-to-end accuracy-loop run.

    ``spar_grid`` lists the (Spar_x, Spar_h) tuples swept (each gets its
    own masked retrain); the FIRST tuple is the primary point the quality
    gate reads. Every tuple is crossed with {fp32, ``quant``} ×
    {Θ=0, ``theta``}. ``device`` (default ``cuda``; raises without a card
    unless ``"cpu"`` is given) holds the params, batches and kernels;
    ``backend`` is the kernel backend ("auto" | "cuda" | "ref"). ``mesh``
    (data, model): both training phases sharded over that many ranks."""

    corpus: str = "char"            # char | frame | zipf
    embed: int = 32                 # LM embedding width / frame input dim
    hidden: int = 64
    num_layers: int = 1
    vocab: int = 64                 # zipf corpus only (char derives its own)
    frame_classes: int = 16         # frame corpus only
    train_steps: int = 300
    retrain_steps: int = 200
    batch: int = 16
    seq_len: int = 32
    lr: float = 5e-3
    retrain_lr: float = 2e-3
    spar_grid: tuple = ((0.75, 0.5), (0.875, 0.625))
    quant: str = "int8"
    theta: float = 0.05
    eval_batches: int = 4
    eval_batch: int = 16
    eval_seq: int = 32
    gen_batch: int = 4
    gen_prompt: int = 8
    gen_steps: int = 16
    seed: int = 0
    backend: str = "auto"
    mesh: tuple | None = None       # (data, model) training mesh
    device: str | None = None


# --------------------------------------------------------------- task setup

def build_task(cfg: PipelineConfig):
    """→ (corpus, LSTMConfig). The corpus is the quality claim's dataset
    stand-in; the LSTMConfig is the deployment the claim is made about."""
    from ..models import LSTMConfig
    from ..training.data import CharCorpus, FrameCorpus, ZipfInduction
    name = f"pipeline_{cfg.corpus}"
    if cfg.corpus == "char":
        corpus = CharCorpus(seed=cfg.seed)
        return corpus, LSTMConfig(name, input_size=cfg.embed,
                                  hidden=cfg.hidden,
                                  num_layers=cfg.num_layers,
                                  vocab_size=corpus.vocab_size)
    if cfg.corpus == "zipf":
        corpus = ZipfInduction(vocab_size=cfg.vocab, seed=cfg.seed)
        return corpus, LSTMConfig(name, input_size=cfg.embed,
                                  hidden=cfg.hidden,
                                  num_layers=cfg.num_layers,
                                  vocab_size=cfg.vocab)
    if cfg.corpus == "frame":
        corpus = FrameCorpus(input_size=cfg.embed,
                             num_classes=cfg.frame_classes, seed=cfg.seed)
        return corpus, LSTMConfig(name, input_size=cfg.embed,
                                  hidden=cfg.hidden,
                                  num_layers=cfg.num_layers,
                                  num_classes=cfg.frame_classes,
                                  framewise=True)
    raise ValueError(f"unknown corpus {cfg.corpus!r} "
                     "(expected char | frame | zipf)")


def _as_model_batch(raw: dict, device="cpu") -> dict:
    """Corpus batch → the model.loss contract ({'inputs', 'labels'}) as
    tensors on ``device``."""
    inputs = raw["inputs"] if "inputs" in raw else raw["tokens"]
    return {"inputs": torch.as_tensor(inputs, device=device),
            "labels": torch.as_tensor(raw["labels"], device=device)}


# ----------------------------------------------------------------- training

def _backend_for_ranks(device, ranks: int) -> str | None:
    """gloo where the ranks outnumber the cards (or on the CPU), else the
    default (NCCL on the card)."""
    device = torch.device(device)
    if device.type == "cuda" and ranks <= torch.cuda.device_count():
        return None
    return "gloo"


def _group_mesh(shape, device):
    """A (data, model) DeviceMesh of ``shape`` on ``device`` over the
    initialized process group (torchrun's, or a spawned run's), else
    None."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return None
    from .mesh import make_mesh
    return make_mesh(tuple(shape), device=device, backend=dist.get_backend())


def train_lstm(model, corpus, cfg: PipelineConfig, *, steps: int, lr: float,
               params=None, masks=None, mesh=None, log: Callable = None,
               losses: list | None = None):
    """Train (or masked-retrain) the LSTM for ``steps`` on ``corpus``.

    ``masks`` switches on BRDS retraining — gradients of pruned weights
    are zeroed and the masks re-applied after every update, exactly the
    paper's retrain phase. ``params`` None: a seeded init on the config's
    device (the batches go where the params lie). ``mesh`` routes the step
    through ``jit_train_step``: a DeviceMesh of this rank, or (data,
    model) over the initialized process group; the params come back
    whole. ``losses``: a list that takes every step's loss. Returns
    (params, final_loss)."""
    from ..device import resolve_device
    from ..training import OptConfig, init_state, make_train_step
    from ..training.data import ShardedLoader
    if isinstance(mesh, (tuple, list)):
        shape = tuple(mesh)
        mesh = _group_mesh(shape, _device_of(params) if params is not None
                           else resolve_device(cfg.device))
        if mesh is None:
            raise ValueError(f"train_lstm(mesh={shape}) runs on initialized "
                             "ranks (run_pipeline spawns them, or torchrun "
                             "starts them); pass a DeviceMesh or start them")
    if params is None:
        params = model.init(torch.Generator().manual_seed(cfg.seed),
                            device=resolve_device(cfg.device))
    device = _device_of(params)
    oc = OptConfig(lr=lr, total_steps=steps,
                   warmup_steps=max(1, steps // 20))
    opt_state = init_state(oc, params)
    # the train-step factory only reads grad_accum off the arch config
    arch = types.SimpleNamespace(grad_accum=1, zero1=True)
    loader = ShardedLoader(corpus, cfg.batch, cfg.seq_len)
    if mesh is None:
        step_fn = make_train_step(model, arch, oc, masks)
    else:
        from ..training import jit_train_step
        step_fn = jit_train_step(mesh, model, arch, oc,
                                 _as_model_batch(loader.batch(0)), masks)
    metrics = {"loss": float("nan")}
    for step in range(steps):
        batch = _as_model_batch(loader.batch(step), device)
        params, opt_state, metrics = step_fn(params, opt_state, batch, step)
        if losses is not None:
            losses.append(float(metrics["loss"]))
        if log is not None and (step % 100 == 0 or step == steps - 1):
            log(f"  step {step:4d} loss {float(metrics['loss']):.4f}")
    if mesh is not None:
        # whole params for prune, pack and serve
        from ..dist.collective_ops import full_tensor
        from ..training.tree import tree_map
        params = tree_map(full_tensor, params)
    return params, float(metrics["loss"])


# --------------------------------------------------------------- evaluation

def evaluate(model, params, batches) -> dict:
    """Eval ``params`` over held-out ``batches`` through the SERVING step
    path (``LSTMModel.score``), without autograd — the quality of the
    deployed model, valid for dense, packed, quantized, and temporal-delta
    param/model pairs. Returns {'nll', 'ppl'} (+ 'acc' for classifiers,
    on dense trees)."""
    from ..core.metrics import perplexity, token_accuracy
    dev = _device_of(params)
    dense_tree = not model.is_packed(params)
    nlls, accs = [], []
    with torch.no_grad():
        for raw in batches:
            b = _as_model_batch(raw, dev)
            nlls.append(float(model.score(params, b["inputs"], b["labels"])))
            if not model.cfg.vocab_size and dense_tree:
                logits = model.forward(params, b["inputs"])
                accs.append(token_accuracy(logits, b["labels"]))
    out = {"nll": float(np.mean(nlls)), "ppl": perplexity(np.mean(nlls))}
    if accs:
        out["acc"] = float(np.mean(accs))
    return out


def _device_of(params) -> torch.device:
    b = params["layers"][0]["b"]
    return b.device


# ------------------------------------------------- deployment (two routes)

def _policy_at(cfg: PipelineConfig, spar_x: float, spar_h: float,
               scheme: str | None, theta: float):
    from ..sparse import DeltaGateConfig, QuantConfig, lstm_policy
    delta = (DeltaGateConfig(theta_x=theta, theta_h=theta)
             if theta > 0 else None)
    quant = QuantConfig(scheme) if scheme else None
    return lstm_policy(spar_x, spar_h, delta=delta, quant=quant)


def prepare_manual(model, policy, params, calib=None):
    """The deployment composed BY HAND from the public pieces — compile →
    prune → pack (→ quantize) → pad, plus the delta/quant model rewiring.
    ``ServeEngine.prepare`` must reproduce this bitwise; ``run_point``
    asserts it. Returns (model', packed_params, report)."""
    from ..quant import calibrate_lstm
    plan = policy.compile(params)
    if plan.activation is not None:
        model = model.with_delta(plan.activation)
    if plan.quant is not None:
        if calib is None:
            raise ValueError("quantized deployment needs a calib batch")
        model = model.with_quant(
            calibrate_lstm(model, params, calib, plan.quant))
    pruned, masks = plan.prune(params)
    packed, report = plan.pack(pruned, masks)
    packed = model.pad_packed_params(packed)
    return model, packed, report


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _time_call(fn, device, warmup: int = 1, iters: int = 3) -> float:
    """Median wall seconds per call (the first call, which captures a
    decode graph on the card, is a warm-up)."""
    for _ in range(warmup):
        fn()
    _sync(device)
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def _serve_throughput(engine, params, model_cfg, cfg: PipelineConfig,
                      eval_batch) -> float:
    """Serving tokens/s for this deployment. LMs run a real greedy
    ``ServeEngine.generate``; framewise classifiers (whose decode feeds
    class ids, not frames) time the serving-path scorer instead — frames/s
    through the same packed kernels."""
    dev = engine.device
    with torch.no_grad():
        if model_cfg.vocab_size:
            prompt = torch.as_tensor(
                eval_batch["tokens"][:cfg.gen_batch, :cfg.gen_prompt],
                device=dev)
            dt = _time_call(
                lambda: engine.generate(params, prompt, cfg.gen_steps), dev)
            return cfg.gen_batch * cfg.gen_steps / dt
        b = _as_model_batch(eval_batch, dev)
        dt = _time_call(
            lambda: engine.model.score(params, b["inputs"], b["labels"]),
            dev)
        return b["inputs"].shape[0] * b["inputs"].shape[1] / dt


def run_point(model, lcfg, retrained, cfg: PipelineConfig, spar_x, spar_h,
              scheme, theta, eval_set, calib, gen_batch_raw) -> dict:
    """One grid point: deploy ``retrained`` at (spar_x, spar_h) with the
    given quant scheme and delta threshold through BOTH routes, assert the
    bitwise serving-parity invariant, and measure quality + speed."""
    from ..models import LSTMModel
    from ..serving import ServeEngine
    policy = _policy_at(cfg, spar_x, spar_h, scheme, theta)
    needs_calib = scheme is not None
    # route 1: the serving stack end to end
    engine = ServeEngine(LSTMModel(lcfg),
                         max_len=cfg.gen_prompt + cfg.gen_steps,
                         sparsity=policy, device=_device_of(retrained))
    served_params, report = engine.prepare(
        retrained, calib=calib if needs_calib else None)
    served = evaluate(engine.model, served_params, eval_set)
    # route 2: the same deployment composed by hand
    manual_model, manual_packed, _ = prepare_manual(
        LSTMModel(lcfg), policy, retrained,
        calib=calib if needs_calib else None)
    manual = evaluate(manual_model, manual_packed, eval_set)
    if served["nll"] != manual["nll"]:
        raise PipelineError(
            f"serving stack changed quality at (Spar_x={spar_x}, "
            f"Spar_h={spar_h}, scheme={scheme}, theta={theta}): "
            f"served nll {served['nll']!r} != manual nll {manual['nll']!r}")
    toks_per_s = _serve_throughput(engine, served_params, lcfg, cfg,
                                   gen_batch_raw)
    return {"metrics": served, "weight_bytes": int(report["packed_bytes"]),
            "dense_bytes": int(report["dense_bytes"]),
            "toks_per_s": toks_per_s}


# -------------------------------------------------------------- the driver

def run_pipeline(cfg: PipelineConfig, *, smoke: bool = False,
                 log: Callable = print) -> dict:
    """The full arc. Returns the BENCH_pipeline payload:
    {'benchmark', 'smoke', 'wall_time_s', 'rows', 'gate'} — rows in the
    ``benchmarks/common.py`` record shape (name + us_per_call + derived
    fields), gate the primary-point quality summary the CLI enforces.
    With ``cfg.mesh`` and no initialized process group, the whole run goes
    to spawned ranks (rank 0 logs; its payload is returned)."""
    import torch.distributed as dist
    from ..device import resolve_device
    from ..models import LSTMModel
    from ..obs import trace as obs_trace
    from ..sparse import use_backend
    if cfg.mesh is not None and not dist.is_initialized():
        from .mesh import run_ranks
        home = resolve_device(cfg.device)
        d, m = cfg.mesh
        return run_ranks(_pipeline_rank, d, m, device=home,
                         backend=_backend_for_ranks(home, d * m),
                         args=(cfg, smoke))[0]
    t_all = time.time()
    device = resolve_device(cfg.device)
    corpus, lcfg = build_task(cfg)
    model = LSTMModel(lcfg)
    eval_set = corpus.eval_batches(cfg.eval_batches, cfg.eval_batch,
                                   cfg.eval_seq)
    calib = _as_model_batch(
        corpus.batch(1 << 41, cfg.eval_batch, cfg.eval_seq),
        device)["inputs"]
    gen_raw = corpus.batch(1 << 42, max(cfg.gen_batch, 1), cfg.eval_seq)

    with use_backend(cfg.backend):
        if cfg.mesh is not None:
            log(f"mesh: data={cfg.mesh[0]} model={cfg.mesh[1]} over "
                f"{cfg.mesh[0] * cfg.mesh[1]} ranks, {dist.get_backend()} "
                "(sharded dense train + masked retrain)")
        log(f"[1/4] train dense: corpus={cfg.corpus} H={cfg.hidden} "
            f"L={cfg.num_layers} steps={cfg.train_steps}")
        with obs_trace.span("pipeline.train_dense", steps=cfg.train_steps):
            dense_params, loss = train_lstm(model, corpus, cfg,
                                            steps=cfg.train_steps,
                                            lr=cfg.lr, mesh=cfg.mesh,
                                            log=log)
        dense = evaluate(model, dense_params, eval_set)
        log(f"      dense eval: ppl {dense['ppl']:.4f}"
            + (f" acc {dense['acc']:.3f}" if "acc" in dense else ""))
        dense_row = {"name": "pipeline_dense", "us_per_call": 0.0,
                     "ppl": dense["ppl"], "nll": dense["nll"],
                     "train_loss": round(loss, 5)}
        if "acc" in dense:
            dense_row["acc"] = dense["acc"]
        rows = [dense_row]

        gate_info = None
        parity_points = 0
        for gi, (spar_x, spar_h) in enumerate(cfg.spar_grid):
            log(f"[2/4] prune+retrain (Spar_x={spar_x}, Spar_h={spar_h}) "
                f"steps={cfg.retrain_steps}")
            with obs_trace.span("pipeline.prune_retrain", spar_x=spar_x,
                                spar_h=spar_h, steps=cfg.retrain_steps):
                plan = _policy_at(cfg, spar_x, spar_h, None, 0.0).compile(
                    dense_params)
                pruned, masks = plan.prune(dense_params)
                retrained, _ = train_lstm(model, corpus, cfg,
                                          steps=cfg.retrain_steps,
                                          lr=cfg.retrain_lr, params=pruned,
                                          masks=masks, mesh=cfg.mesh,
                                          log=log)
            for scheme in (None, cfg.quant):
                for theta in (0.0, cfg.theta):
                    with obs_trace.span("pipeline.run_point", spar_x=spar_x,
                                        spar_h=spar_h, theta=theta,
                                        scheme=scheme or "fp32"):
                        point = run_point(model, lcfg, retrained, cfg,
                                          spar_x, spar_h, scheme, theta,
                                          eval_set, calib, gen_raw)
                    parity_points += 1
                    met = point["metrics"]
                    delta_pct = (100.0 * (met["ppl"] - dense["ppl"])
                                 / dense["ppl"])
                    sname = scheme or "fp32"
                    name = (f"pipeline_sx{spar_x}_sh{spar_h}_{sname}"
                            f"_t{theta}")
                    us = 1e6 / max(point["toks_per_s"], 1e-9)
                    log(f"[3/4] {name}: ppl {met['ppl']:.4f} "
                        f"({delta_pct:+.2f}% vs dense), "
                        f"{point['weight_bytes']} weight bytes, "
                        f"{point['toks_per_s']:.0f} tok/s [serving parity "
                        f"bitwise OK]")
                    row = {"name": name, "us_per_call": round(us, 3),
                           "ppl": met["ppl"], "ppl_delta_pct": delta_pct,
                           "weight_bytes": point["weight_bytes"],
                           "compression": point["weight_bytes"]
                           / max(point["dense_bytes"], 1),
                           "toks_per_s": point["toks_per_s"],
                           "spar_x": spar_x, "spar_h": spar_h,
                           "theta": theta, "scheme": sname}
                    if "acc" in met:
                        row["acc"] = met["acc"]
                    rows.append(row)
                    if gi == 0 and scheme is None and theta == 0.0:
                        gate_info = {"spar_x": spar_x, "spar_h": spar_h,
                                     "ppl_dense": dense["ppl"],
                                     "ppl_sparse": met["ppl"],
                                     "ppl_delta_pct": delta_pct}
    rows.append({"name": "pipeline_serve_parity", "us_per_call": 0.0,
                 "bitwise": 1, "points": parity_points})
    payload = {"benchmark": "pipeline", "smoke": smoke,
               "wall_time_s": round(time.time() - t_all, 3),
               "rows": rows, "gate": gate_info}
    log(f"[4/4] done in {payload['wall_time_s']:.1f}s — {parity_points} "
        "grid points, serving parity bitwise at every one")
    return payload


def _pipeline_rank(mesh, cfg: PipelineConfig, smoke: bool):
    """One spawned rank of a ``cfg.mesh`` run: the whole pipeline; rank 0
    prints."""
    import torch.distributed as dist
    return run_pipeline(cfg, smoke=smoke,
                        log=print if dist.get_rank() == 0
                        else (lambda *a, **k: None))


def write_bench(payload: dict, out_dir: str | None = None) -> str:
    """Write BENCH_pipeline.json (REPRO_BENCH_DIR honored, like the
    reference's ``benchmarks/run.py``). Returns the path."""
    out_dir = out_dir or os.environ.get("REPRO_BENCH_DIR", ".")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "BENCH_pipeline.json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")
    return path


# ------------------------------------------------------------------ the CLI

def _parse_grid(spec: str) -> tuple:
    out = []
    for part in spec.split(","):
        sx, sh = part.split(":")
        out.append((float(sx), float(sh)))
    return tuple(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="train -> prune -> retrain -> calibrate -> pack -> "
                    "serve, with perplexity as a gate")
    ap.add_argument("--corpus", default="char",
                    choices=("char", "frame", "zipf"))
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized shapes/steps (the quality-smoke job)")
    ap.add_argument("--hidden", type=int, default=None)
    ap.add_argument("--embed", type=int, default=None)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--retrain-steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--retrain-lr", type=float, default=None)
    ap.add_argument("--grid", default=None, metavar="SX:SH,SX:SH",
                    help="(Spar_x, Spar_h) tuples; the first is the "
                         "gate's primary point (default 0.75:0.5,"
                         "0.875:0.625)")
    ap.add_argument("--quant", default="int8", metavar="SCHEME",
                    help="quant leg of the grid ('int8' or qM.N)")
    ap.add_argument("--theta", type=float, default=0.05,
                    help="delta-gating leg of the grid (Theta > 0)")
    ap.add_argument("--gate", type=float, default=5.0, metavar="PCT",
                    help="max allowed retrained-perplexity delta vs dense "
                         "at the primary tuple, percent (negative "
                         "disables; exit 1 past it)")
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "ref", "cuda"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="shard both training phases over a (data, model) "
                         "mesh of DATA x MODEL ranks (spawned, or the "
                         "torchrun group; on one card they share it under "
                         "gloo)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a "
                         "card unless 'cpu' is given)")
    ap.add_argument("--out", default=None,
                    help="BENCH_pipeline.json directory (default "
                         "$REPRO_BENCH_DIR or cwd)")
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="record a Chrome-trace of the pipeline phases "
                         "(repro_torch.obs spans) to FILE")
    args = ap.parse_args(argv)

    overrides: dict[str, Any] = {"corpus": args.corpus, "seed": args.seed,
                                 "backend": args.backend,
                                 "quant": args.quant, "theta": args.theta,
                                 "device": args.device}
    if not args.smoke:
        # full-size defaults (smoke keeps the dataclass defaults)
        overrides.update(hidden=128, embed=64, train_steps=800,
                         retrain_steps=400, seq_len=48, eval_seq=48)
    for key, val in (("hidden", args.hidden), ("embed", args.embed),
                     ("num_layers", args.layers),
                     ("train_steps", args.steps),
                     ("retrain_steps", args.retrain_steps),
                     ("batch", args.batch), ("seq_len", args.seq),
                     ("lr", args.lr), ("retrain_lr", args.retrain_lr)):
        if val is not None:
            overrides[key] = val
    if args.grid is not None:
        overrides["spar_grid"] = _parse_grid(args.grid)
    if args.mesh is not None:
        try:
            d, m = (int(v) for v in args.mesh.split(","))
        except ValueError:
            ap.error(f"--mesh wants 'DATA,MODEL' ints, got {args.mesh!r}")
        if d < 1 or m < 1:
            ap.error(f"--mesh {args.mesh}: sizes must be positive")
        overrides["mesh"] = (d, m)
    cfg = PipelineConfig(**overrides)
    import torch.distributed as dist
    if (cfg.mesh is not None and not dist.is_initialized()
            and "RANK" in os.environ and "WORLD_SIZE" in os.environ):
        # under torchrun: this process is one rank of the mesh
        from ..device import resolve_device
        dev = resolve_device(cfg.device)
        dist.init_process_group(_backend_for_ranks(
            dev, cfg.mesh[0] * cfg.mesh[1]) or "nccl")
        if dev.type == "cuda":
            torch.cuda.set_device(dist.get_rank()
                                  % torch.cuda.device_count())
    lead = not dist.is_initialized() or dist.get_rank() == 0

    if args.trace:
        from ..obs import trace as obs_trace
        obs_trace.enable()
    if not lead:
        # another torchrun rank: the same run, silent, nothing written
        import contextlib
        with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
            run_pipeline(cfg, smoke=args.smoke)
        return 0
    payload = run_pipeline(cfg, smoke=args.smoke)
    if args.trace:
        obs_trace.save(args.trace)
        print(f"trace: {args.trace} "
              f"({len(obs_trace.get_tracer().events)} events)")
    path = write_bench(payload, args.out)
    print(f"wrote {path} ({len(payload['rows'])} rows)")
    gate = payload["gate"]
    if gate is not None and args.gate >= 0:
        if gate["ppl_delta_pct"] > args.gate:
            print(f"QUALITY GATE FAIL: ppl delta "
                  f"{gate['ppl_delta_pct']:+.2f}% > {args.gate:.2f}% at "
                  f"(Spar_x={gate['spar_x']}, Spar_h={gate['spar_h']}) "
                  f"(dense {gate['ppl_dense']:.4f} -> sparse "
                  f"{gate['ppl_sparse']:.4f})")
            return 1
        print(f"quality gate OK: ppl delta {gate['ppl_delta_pct']:+.2f}% "
              f"<= {args.gate:.2f}% at (Spar_x={gate['spar_x']}, "
              f"Spar_h={gate['spar_h']})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

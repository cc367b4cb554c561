"""End-to-end training driver (the port of ``repro/launch/train.py``).

CPU-scale example (a reduced config of the same family):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --smoke --device cpu --steps 6 --batch 4 --seq 32 --brds

On the card (the default device), at the architecture's full width:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --brds --steps 6 --batch 4 --seq 256 --save-every 2

Features: gradient accumulation (``cfg.grad_accum``), BRDS masked sparse
training (``--brds``), checkpoint / restart (auto-resume from the newest
valid checkpoint in ``--ckpt-dir``), fault injection (``--inject-failure-at``: restore the
newest checkpoint and replay from its step) and straggler monitoring.
``--mesh pod|multipod`` trains through the sharded step
(``training.jit_train_step``) on ``launch.mesh.make_production_mesh``: run
it under ``torchrun`` with 256 (512) ranks, one card each; a run over
another number of ranks stops with the number it needs. ``--mesh D,M``
trains on a (data, model) mesh of D·M ranks, spawned here
(``launch.mesh.run_ranks``; rank 0 prints) or joined under ``torchrun``:
every family of the zoo, tensor-parallel over ``model`` (the loss on each
rank's vocabulary columns) and data-parallel over ``data``, e.g.

  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-7b \\
      --smoke --device cpu --mesh 1,2 --steps 4 --batch 4 --seq 32

On cards the ranks take one each under NCCL, or share them under gloo
where they outnumber them. An encoder-decoder's batches carry frame
embeddings (B, seq, d) drawn from the step's seed. ``_train(args,
ckpt_dir, mesh)`` is the same body over any mesh. Without ``--ckpt-dir`` the checkpoints go to a fresh
temporary directory that the run removes at its end, so a run resumes only
from a directory it is given; a mesh whose ranks run on more than one host
needs ``--ckpt-dir`` on a filesystem every host sees (rank 0 writes, every
rank restores), and the ranks check that they resumed the same step.
"""
from __future__ import annotations

import argparse
import shutil
import tempfile
import time


def parser() -> argparse.ArgumentParser:
    """The reference's flags and defaults, plus ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory, resumed from if it holds "
                         "one (default: a fresh temporary directory, "
                         "removed at the end of the run)")
    ap.add_argument("--save-every", type=int, default=20)
    ap.add_argument("--mesh", default="host",
                    help="host (one device), pod / multipod (the "
                         "production meshes, under torchrun) or DATA,MODEL "
                         "(a mesh of spawned ranks)")
    ap.add_argument("--brds", action="store_true",
                    help="apply BRDS dual-ratio masks and retrain")
    ap.add_argument("--spar-a", type=float, default=0.75)
    ap.add_argument("--spar-b", type=float, default=0.5)
    ap.add_argument("--inject-failure-at", type=int, default=-1,
                    help="raise at this step once (tests restart path)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a "
                         "card unless 'cpu' is given)")
    return ap


def main(argv=None) -> dict:
    """Train; returns {"losses": {step: loss}, "step_ms": {step: ms},
    "resumed_from": [steps restored], "stragglers": n, "final_step": n,
    "ckpt_dir": path} (the last run of a replayed step wins)."""
    ap = parser()
    args = ap.parse_args(argv)
    if args.mesh not in ("host", "pod", "multipod"):
        return _launch_mesh(args, argv, *_mesh_shape(ap, args.mesh))
    mesh = None if args.mesh == "host" else _production_mesh(args)
    return _run(args, mesh)


def _run(args, mesh) -> dict:
    """``_train`` in ``--ckpt-dir`` or a fresh temporary directory (rank
    0's under a mesh), removed at the end."""
    if args.ckpt_dir is not None:
        return _train(args, args.ckpt_dir, mesh)
    ckpt_dir = _shared_tempdir(mesh)
    try:
        return _train(args, ckpt_dir, mesh)
    finally:
        if mesh is None or _rank() == 0:
            shutil.rmtree(ckpt_dir, ignore_errors=True)


def _mesh_shape(ap, text: str) -> tuple[int, int]:
    try:
        d, m = (int(v) for v in text.split(","))
    except ValueError:
        ap.error(f"--mesh wants host, pod, multipod or 'DATA,MODEL' ints, "
                 f"got {text!r}")
    if d < 1 or m < 1:
        ap.error(f"--mesh {text}: sizes must be positive")
    return d, m


def _train_rank(mesh, argv):
    """One rank of a ``--mesh DATA,MODEL`` run: the run over ``mesh``;
    only rank 0 prints."""
    import contextlib
    import os
    import torch.distributed as dist
    args = parser().parse_args(argv)
    if dist.get_rank() == 0:
        return _run(args, mesh)
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
        return _run(args, mesh)


def _launch_mesh(args, argv, data: int, model: int) -> dict:
    """The run on ``data × model`` ranks: in this process under torchrun
    (its environment names the rank), else spawned. Returns rank 0's
    summary."""
    import os
    import torch.distributed as dist
    from repro_torch.device import resolve_device
    from repro_torch.launch import mesh as M
    import torch
    device = resolve_device(args.device)
    # NCCL with a card a rank; gloo where the ranks share the cards
    shared = (device.type == "cuda"
              and data * model > torch.cuda.device_count())
    backend = M.backend_for(device, data * model, "gloo" if shared else None)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
        try:
            return _train_rank(M.make_mesh((data, model), device=device,
                                           backend=backend), argv)
        finally:
            dist.destroy_process_group()
    threads = max(1, (os.cpu_count() or 1) // (data * model))
    return M.run_ranks(_train_rank, data, model, device=device,
                       backend=backend, args=(argv,), threads=threads,
                       timeout=1800.0)[0]


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _production_mesh(args):
    """``--mesh pod|multipod``: the production mesh over the torchrun
    group (joined here when the environment names one)."""
    import os
    import torch.distributed as dist
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_production_mesh
    device = resolve_device(args.device)
    if (not dist.is_initialized() and "RANK" in os.environ
            and "WORLD_SIZE" in os.environ):
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return make_production_mesh(multi_pod=args.mesh == "multipod",
                                device=device)


def _shared_tempdir(mesh) -> str:
    """A fresh temporary directory, rank 0's for every rank of a mesh
    whose ranks share one host; a mesh over several hosts raises (rank 0's
    directory is not on the others': ``--ckpt-dir`` names a shared one)."""
    if mesh is None:
        return tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    import socket
    import torch.distributed as dist
    hosts = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, socket.gethostname())
    if len(set(hosts)) > 1:
        raise ValueError(
            f"--mesh over ranks on {len(set(hosts))} hosts: pass --ckpt-dir "
            "on a filesystem every host sees (rank 0 writes the "
            "checkpoints, every rank restores them)")
    box = [tempfile.mkdtemp(prefix="repro_torch_ckpt_")
           if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _agreed_step(mesh, step):
    """``step`` (a resumed step, or None), checked alike on every rank of
    ``mesh``: ranks that restored different steps (a checkpoint directory
    that not every rank sees) would fall out of step, so that raises."""
    if mesh is None:
        return step
    import torch
    from repro_torch.dist.collective_ops import all_reduce
    v = torch.tensor([-1 if step is None else step], dtype=torch.int64)
    lo, hi = int(all_reduce(v, op="min")), int(all_reduce(v, op="max"))
    if lo != hi:
        raise RuntimeError(
            f"the ranks resumed from different steps ({lo} to {hi}; -1: no "
            "checkpoint): every rank must see the same --ckpt-dir")
    return step


def _resume(ckpt, params, opt_state, shardings=None):
    """(params, opt_state, step) of the newest valid checkpoint, or the
    arguments and None where there is none; laid out by ``shardings``
    ((param, optimizer) shardings) under a mesh. Holds no reference to
    the restored state, so a replaced one is freed at its caller's next
    step."""
    try:
        (params, opt_state), meta = ckpt.restore((params, opt_state),
                                                 shardings=shardings)
    except FileNotFoundError:
        return params, opt_state, None
    return params, opt_state, meta["step"]


def _train(args, ckpt_dir: str, mesh=None) -> dict:
    """The training run, on one device or, with ``mesh`` (a DeviceMesh
    over initialized ranks), through ``jit_train_step`` on it: every rank
    runs this body on the same global batches."""

    import torch

    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.models import build_model
    from repro_torch.sparse import transformer_policy
    from repro_torch.training import (CheckpointManager, OptConfig,
                                      ShardedLoader, StragglerMonitor,
                                      ZipfInduction, init_state,
                                      jit_train_step, make_train_step)
    from repro_torch.training.train_loop import (init_sharded,
                                                 opt_shardings,
                                                 param_shardings,
                                                 prune_sharded)

    device = resolve_device(args.device)
    if mesh is not None and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    cfg = smoke_config(args.arch) if args.smoke else get_arch(args.arch)
    model = build_model(cfg)
    print(f"arch={cfg.name} params={model.param_count()/1e6:.1f}M "
          f"layers={cfg.num_layers}")

    oc = OptConfig(lr=args.lr, total_steps=args.steps,
                   warmup_steps=max(args.steps // 20, 1))
    gen = torch.Generator().manual_seed(0)
    if mesh is None:
        params = model.init(gen, device=device)
        opt_state = init_state(oc, params)
    else:       # each rank draws its pieces: no whole copy of the model
        params, opt_state = init_sharded(mesh, model, oc, gen, device,
                                         zero1=getattr(cfg, "zero1", True))

    masks = None
    if args.brds:
        plan = transformer_policy(args.spar_a, args.spar_b).compile(params)
        if mesh is None:
            params, masks = plan.prune(params)
            print("BRDS:", plan.summary(masks))
        else:
            params, masks, report = prune_sharded(plan, params)
            print("BRDS:", report)
    ds = ZipfInduction(vocab_size=cfg.vocab_size)
    loader = ShardedLoader(ds, args.batch, args.seq)
    shardings = None
    if mesh is None:
        step_fn = make_train_step(model, cfg, oc, masks)
    else:
        batch_abs = {k: torch.as_tensor(v)
                     for k, v in _batch(loader, cfg, 0).items()}
        step_fn = jit_train_step(mesh, model, cfg, oc, batch_abs, masks)
        p_sh = param_shardings(mesh, model)
        shardings = (p_sh, opt_shardings(mesh, oc, p_sh, model.param_defs(),
                                         zero1=getattr(cfg, "zero1", True)))
        print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))}")

    ckpt = CheckpointManager(ckpt_dir, keep=2)
    mon = StragglerMonitor()
    out = {"losses": {}, "step_ms": {}, "resumed_from": [],
           "ckpt_dir": ckpt_dir}

    params, opt_state, resumed = _resume(ckpt, params, opt_state, shardings)
    resumed = _agreed_step(mesh, resumed)
    step = resumed or 0
    if resumed is not None:
        out["resumed_from"].append(step)
        print(f"resumed from checkpoint at step {step}")

    injected = False
    t_all = time.time()
    while step < args.steps:
        if step == args.inject_failure_at and not injected:
            injected = True
            print(f"!! injecting failure at step {step}; restarting from "
                  f"checkpoint")
            ckpt.wait()                        # an async save in flight
            params, opt_state, resumed = _resume(ckpt, params, opt_state,
                                                 shardings)
            resumed = _agreed_step(mesh, resumed)
            if resumed is not None:
                step = resumed
                out["resumed_from"].append(step)
                continue
        t0 = time.time()
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in _batch(loader, cfg, step).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch, step)
        loss = float(metrics["loss"])          # waits for the step
        dt = time.time() - t0
        straggler = mon.record(dt)
        out["losses"][step] = loss
        out["step_ms"][step] = dt * 1e3
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} {dt*1e3:.0f}ms"
                  + (" [straggler]" if straggler else ""))
        if (step + 1) % args.save_every == 0:
            ckpt.save(step + 1, (params, opt_state))
        step += 1
    ckpt.wait()
    print(f"done in {time.time()-t_all:.1f}s; straggler events: {mon.flagged}")
    out.update(stragglers=mon.flagged, final_step=step)
    return out


def _batch(loader, cfg, step: int) -> dict:
    """The loader's batch of ``step``; an encoder-decoder's with frame
    embeddings (B, seq, d) drawn from the step's seed, as the serving CLI
    draws its frames."""
    import numpy as np
    b = loader.batch(step)
    if getattr(cfg, "encdec", False):
        B, S = b["tokens"].shape
        b = dict(b, frames=np.random.default_rng(step).normal(
            size=(B, S, cfg.d_model)).astype(np.float32))
    return b


if __name__ == "__main__":
    main()

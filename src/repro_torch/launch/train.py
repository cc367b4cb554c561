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
``--mesh pod|multipod`` (the sharded train step) comes in slice 19 (ROADMAP
queue A item 7, the training half) and raises. Without ``--ckpt-dir`` the checkpoints go to a fresh
temporary directory that the run removes at its end, so a run resumes only
from a directory it is given.
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
                    choices=["host", "pod", "multipod"])
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
    args = parser().parse_args(argv)
    if args.mesh != "host":
        raise NotImplementedError(
            f"--mesh {args.mesh} (the sharded train step) comes in slice "
            "19 (ROADMAP queue A item 7, the training half); train on one "
            "device")
    if args.ckpt_dir is not None:
        return _train(args, args.ckpt_dir)
    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    try:
        return _train(args, ckpt_dir)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def _resume(ckpt, params, opt_state):
    """(params, opt_state, step) of the newest valid checkpoint, or the
    arguments and None where there is none. Holds no reference to the
    restored state, so a replaced one is freed at its caller's next step."""
    try:
        (params, opt_state), meta = ckpt.restore((params, opt_state))
    except FileNotFoundError:
        return params, opt_state, None
    return params, opt_state, meta["step"]


def _train(args, ckpt_dir: str) -> dict:

    import torch

    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.models import build_model
    from repro_torch.sparse import transformer_policy
    from repro_torch.training import (CheckpointManager, OptConfig,
                                      ShardedLoader, StragglerMonitor,
                                      ZipfInduction, init_state,
                                      make_train_step)

    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_arch(args.arch)
    model = build_model(cfg)
    print(f"arch={cfg.name} params={model.param_count()/1e6:.1f}M "
          f"layers={cfg.num_layers}")

    params = model.init(torch.Generator().manual_seed(0), device=device)
    oc = OptConfig(lr=args.lr, total_steps=args.steps,
                   warmup_steps=max(args.steps // 20, 1))
    opt_state = init_state(oc, params)

    masks = None
    if args.brds:
        plan = transformer_policy(args.spar_a, args.spar_b).compile(params)
        params, masks = plan.prune(params)
        print("BRDS:", plan.summary(masks))
    step_fn = make_train_step(model, cfg, oc, masks)

    ds = ZipfInduction(vocab_size=cfg.vocab_size)
    loader = ShardedLoader(ds, args.batch, args.seq)
    ckpt = CheckpointManager(ckpt_dir, keep=2)
    mon = StragglerMonitor()
    out = {"losses": {}, "step_ms": {}, "resumed_from": [],
           "ckpt_dir": ckpt_dir}

    params, opt_state, resumed = _resume(ckpt, params, opt_state)
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
            params, opt_state, resumed = _resume(ckpt, params, opt_state)
            if resumed is not None:
                step = resumed
                out["resumed_from"].append(step)
                continue
        t0 = time.time()
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in loader.batch(step).items()}
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


if __name__ == "__main__":
    main()

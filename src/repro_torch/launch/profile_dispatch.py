"""Time the cost of the kernel entry points' dry-run branch on the serve
path: the host loop's wall a step (``chip_smoke.py`` phase 3's float
fused lstm_ptb path: B=8, prompt 32, gen 64, ``runtime.decode_loop_eager``
after the prefill) with

* ``branch``: the entry points as shipped: a fake-tensor check
  (``ops._is_fake``) before each kernel launch, and the launch itself a
  direct ctypes call;
* ``custom_op``: the same launch behind a ``torch.library.custom_op``
  with a registered fake (``register_fake``): PyTorch's idiom for a
  kernel a trace can see, whose dispatch every launch then pays.

The two alternate (branch, custom_op, branch, custom_op, ...), each the
median of ``--runs`` host loops; the tokens of both are held equal.

    PYTHONPATH=src python -m repro_torch.launch.profile_dispatch [--runs 5]
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

__all__ = ["main"]

SERVE = dict(batch=8, prompt=32, gen=64)


def _custom_fused_step():
    """The fused float step (B3) as a custom op: the kernel's launcher as
    its implementation, its outputs' shapes as its fake."""
    from ..kernels import fused_step

    @torch.library.custom_op("brds_dispatch::fused_brds_lstm_step",
                             mutates_args=())
    def step(vals_x: torch.Tensor, deltas_x: torch.Tensor, x: torch.Tensor,
             vals_h: torch.Tensor, deltas_h: torch.Tensor, h: torch.Tensor,
             bias: torch.Tensor, c_prev: torch.Tensor,
             pwl: bool) -> tuple[torch.Tensor, torch.Tensor]:
        return fused_step.fused_brds_lstm_step(
            vals_x, deltas_x, x, vals_h, deltas_h, h, bias, c_prev, pwl=pwl)

    @step.register_fake
    def _(vals_x, deltas_x, x, vals_h, deltas_h, h, bias, c_prev, pwl):
        return torch.empty_like(c_prev), torch.empty_like(c_prev)

    return lambda *a, pwl=False: step(*a, pwl)


def main(argv=None) -> int:
    from ..kernels import ops
    from ..models import LSTMModel, LSTM_CONFIGS
    from ..serving import SamplingConfig, ServeEngine, runtime
    from ..sparse import lstm_policy
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args(argv)
    device = torch.device("cuda")
    cfg = LSTM_CONFIGS["lstm_ptb"]
    B, P, G = SERVE["batch"], SERVE["prompt"], SERVE["gen"]
    params = LSTMModel(cfg).init(torch.Generator().manual_seed(0), device)
    tokens = torch.randint(0, cfg.vocab_size, (B, P),
                           generator=torch.Generator().manual_seed(1)
                           ).to(device)
    eng = ServeEngine(LSTMModel(cfg), max_len=P + G,
                      sparsity=lstm_policy(0.75, 0.5), device=device)
    packed, _ = eng.prepare(params)

    def host_loop():
        logits, cache = eng.model.prefill(packed, tokens, eng.max_len)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = runtime.decode_loop_eager(eng.model, packed, cache, logits, P,
                                        None, G, SamplingConfig(),
                                        limit=eng.max_len)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / G * 1e3, out[0]

    shipped, custom = ops._fused_kernel, _custom_fused_step()
    walls = {"branch": [], "custom_op": []}
    toks = {}
    host_loop()                     # warm: build and load the kernels
    for _ in range(args.runs):
        for name, kernel in (("branch", shipped), ("custom_op", custom)):
            ops._fused_kernel = kernel
            try:
                ms, toks[name] = host_loop()
            finally:
                ops._fused_kernel = shipped
            walls[name].append(ms)
    if not torch.equal(toks["branch"], toks["custom_op"]):
        raise AssertionError("the custom op changed the tokens")
    print(json.dumps({
        "card": torch.cuda.get_device_name(0),
        "path": "lstm_ptb float fused, B=8, prompt 32, gen 64, host loop",
        **{f"{k}_ms_per_step": statistics.median(v)
           for k, v in walls.items()},
        "runs": walls}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

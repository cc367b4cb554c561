"""The continuous-batching scheduler sharded over a mesh for the model
zoo (``ContinuousBatchingEngine`` on a ``with_mesh`` model: tensor-parallel
prefills, split-KV decode chunks, slots over ``data``), on gloo CPU ranks
at mesh (2, 2), and ``launch.serve --mesh 1,2 --continuous`` /
``--traffic`` end to end.

On smoke qwen3-0.6b, recurrentgemma-9b and seamless-m4t-medium (port
weights from seed 0; seamless-m4t's ``wq`` / ``wk`` scaled by 1/4, as
``tests/test_torch_splitkv_zoo.py`` tempers its scores, and frames for
each request): 4 slots, 6 requests of ragged prompts and budgets, so
slots are reused. Each request's tokens on every rank equal the
one-device scheduler's, at prompts whose one-device greedy top-2 margins
are at least ``MARGIN`` (checked), and those equal a by-hand B=1 greedy
run. Unpartitioned params are refused under a mesh.

The mesh's ranks start once, beside the CLI runs; the rank function lives
here and imports no JAX.
"""
import concurrent.futures
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import run_ranks

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen3-0.6b", "recurrentgemma-9b", "seamless-m4t-medium")
MESH = (2, 2)
SLOTS, MAX_LEN, N_REQ = 4, 32, 6
MARGIN = 1e-3        # the one-device greedy runs' least top-2 gap
TEMPER = 0.25        # seamless-m4t's wq, wk scale
CLI = {("qwen3-0.6b", "--continuous"): ["--batch", "3"],
       ("qwen3-0.6b", "--traffic"): ["--requests", "6", "--rate", "50"],
       ("rwkv6-7b", "--continuous"): ["--batch", "3"],
       ("rwkv6-7b", "--traffic"): ["--requests", "6", "--rate", "50"]}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch):
    """(model, whole params, requests [(prompt (1, S), budget, frames or
    None)]) of ``arch``."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import build_model
    cfg = smoke_config(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    if cfg.encdec:
        for layer in params["enc_blocks"] + params["dec_blocks"]:
            for att in ("attn", "xattn"):
                if att in layer:
                    for w in ("wq", "wk"):
                        layer[att][w] = layer[att][w] * TEMPER
    rng = np.random.default_rng(5)     # least top-2 gaps 1.1e-2 to 3.9e-2
    reqs = []
    for i in range(N_REQ):
        prompt = rng.integers(0, cfg.vocab_size, (1, int(rng.integers(5, 17))))
        frames = (torch.as_tensor(rng.normal(size=(1, cfg.enc_len, cfg.d_model))
                                  .astype(np.float32)) if cfg.encdec else None)
        reqs.append((prompt, int(rng.integers(4, 9)), frames))
    return model, params, reqs


def _serve(model, params, reqs, **kw):
    """Every request through one scheduler: {request index: tokens}."""
    from repro_torch.serving.scheduler import ContinuousBatchingEngine
    sched = ContinuousBatchingEngine(model, params, slots=SLOTS,
                                     max_len=MAX_LEN, device="cpu", **kw)
    uids = [sched.submit(p, b, extra=f) for p, b, f in reqs]
    res = sched.run()
    return {i: res[u].tolist() for i, u in enumerate(uids)}


def _greedy(model, params, prompt, budget, frames):
    """One request's B=1 greedy run by hand: (tokens, least top-2 gap)."""
    kw = {} if frames is None else {"extra": frames}
    logits, cache = model.prefill(params, torch.as_tensor(prompt), MAX_LEN,
                                  **kw)
    V = model.cfg.vocab_size
    toks, gap = [], float("inf")
    for t in range(budget):
        top = torch.topk(logits[:, -1, :V], 2).values
        gap = min(gap, float(top[0, 0] - top[0, 1]))
        tok = int(logits[0, -1, :V].argmax())
        toks.append(tok)
        if t + 1 < budget:
            logits, cache = model.decode_step(
                params, cache, torch.tensor([[tok]], dtype=torch.int32),
                prompt.shape[1] + t)
    return toks, gap


def _rank(mesh):
    """Every arch's requests through the sharded scheduler (the engine's
    prepared pieces, the model over the mesh), and whether whole params
    are refused."""
    from repro_torch.serving import ServeEngine
    from repro_torch.serving.scheduler import ContinuousBatchingEngine
    out = {}
    for arch in ARCHS:
        model, whole, reqs = _setup(arch)
        eng = ServeEngine(model, max_len=MAX_LEN, device="cpu", mesh=mesh)
        p, _ = eng.prepare(whole)
        try:
            ContinuousBatchingEngine(model, whole, slots=SLOTS,
                                     max_len=MAX_LEN, device="cpu", mesh=mesh)
            refused = False
        except ValueError as e:
            refused = "not partitioned" in str(e)
        out[arch] = dict(tokens=_serve(eng.model, p, reqs), refused=refused,
                         meshed=eng.model.mesh is not None)
    return out


@pytest.fixture(scope="module")
def runs():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    clis = {key: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", key[0],
         key[1], "--mesh", "1,2", "--device", "cpu", "--smoke", "--slots",
         "4", "--prompt-len", "12", "--gen", "4", *extra],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for key, extra in CLI.items()}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(run_ranks, _rank, *MESH)
        want = {}
        for arch in ARCHS:
            model, params, reqs = _setup(arch)
            hand = [_greedy(model, params, *r) for r in reqs]
            want[arch] = dict(tokens=_serve(model, params, reqs),
                              hand=[t for t, _ in hand],
                              gap=min(g for _, g in hand))
        ranks = fut.result()
    cli = {k: (p.wait(timeout=600), p.stdout.read()) for k, p in clis.items()}
    return dict(want=want, ranks=ranks, cli=cli)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_device_scheduler_is_greedy(runs, arch):
    """The one-device scheduler's tokens equal each request's B=1 greedy
    run, whose top-2 margins are all at least MARGIN: the prompts are
    margin-checked."""
    want = runs["want"][arch]
    assert want["gap"] >= MARGIN, want["gap"]
    assert [want["tokens"][i] for i in range(N_REQ)] == want["hand"]


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_scheduler_tokens_equal_one_device(runs, arch):
    """Every rank of the (2, 2) mesh (slots over ``data``, each prefill
    tensor-parallel over its ``model`` group, chunks split-KV) returns
    every request's tokens equal to the one-device scheduler's; the
    ranks of a model group alike."""
    want = runs["want"][arch]["tokens"]
    for rk in runs["ranks"]:
        assert rk[arch]["meshed"]
        assert rk[arch]["tokens"] == want


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_scheduler_refuses_whole_params(runs, arch):
    """Under a mesh the scheduler refuses params that are not the rank's
    pieces (``check_splitkv_partitioned``)."""
    assert all(rk[arch]["refused"] for rk in runs["ranks"])


@pytest.mark.parametrize("key", list(CLI), ids=lambda k: f"{k[0]}{k[1]}")
def test_serve_cli_mesh_scheduler(runs, key):
    """``launch.serve --mesh 1,2 --continuous`` and ``--traffic`` serve an
    attention model and rwkv6-7b to exit 0 on two spawned ranks."""
    rc, text = runs["cli"][key]
    assert rc == 0, text[-3000:]
    assert "mesh: data=1 model=2 over 2 ranks, gloo" in text
    if key[1] == "--traffic":
        assert "completed=6 expired=0 rejected=0" in text
    else:
        assert "served 3 ragged requests" in text

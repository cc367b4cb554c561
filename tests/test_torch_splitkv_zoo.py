"""Split-KV sharded serving of the rest of the attention zoo
(``dist.splitkv``, ``TensorParallel.moe``, ``TransformerLM.with_mesh`` /
``EncDecLM.with_mesh``, ``ServeEngine(mesh=)``, ``launch.serve --mesh``)
on gloo CPU ranks at meshes (1, 2) and (2, 2).

On the smoke configs of granite-moe-1b-a400m and qwen3-moe-235b-a22b
(experts over ``model``), seamless-m4t-medium (its ``wq`` / ``wk`` scaled
by 1/4, as ``tests/test_torch_encdec.py`` holds it; 48 frames of an
``enc_len`` of 64, so each rank holds live cross rows), llava-next-34b (4
real q heads stored as 64: at (1, 2) rank 1 holds dummy heads only) and
llama3.2-3b with the int8 KV cache: a sharded prefill and six decode
steps (an int position, then per-row positions), each rank on its data
group's rows, the logits within the zoo's tolerances of the JAX
reference's unsharded ``decode_step`` and within ``SELF_ATOL`` of the
port's one-device step; MoE expert ids, ranks and drop sets exact; the
int8 segment writers bitwise the one-device cache's at every position on
the same k / v (end to end, where k / v differ in their last bits, codes
within one step); greedy
``generate`` tokens equal to one device's at margin-checked inputs; the
dummy heads' outputs exactly 0; the first decode steps and a 12-frame
memory leave segments with no live key. The sharded init's pieces, the
expert-parallel MoE's aux, ``launch.serve --mesh`` on three families end
to end and what it no longer refuses.

Each mesh's ranks start once, all at the same time, beside the CLI
subprocesses; the rank functions live here and import no JAX.
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
MOE = ("granite-moe-1b-a400m", "qwen3-moe-235b-a22b")
ENCDEC, VLM, INT8 = "seamless-m4t-medium", "llava-next-34b", "llama3.2-3b"
ARCHS = MOE + (ENCDEC, VLM, INT8)
OVER = {INT8: {"kv_quant": True}}
# the zoo's parity on the CPU (ROADMAP, "Zoo parity on the CPU";
# tests/test_torch_moe.py, test_torch_encdec.py, test_torch_zoo.py): the
# port's logits against the reference's; llama3.2-3b with the int8 cache
# at the dense smoke llama's 5e-4 (tests/test_torch_transformer.py)
REF_ATOL = {"granite-moe-1b-a400m": 5e-4, "qwen3-moe-235b-a22b": 2e-5,
            ENCDEC: 5e-5, VLM: 2e-4, INT8: 5e-4}
# sharded against the port's one-device step: the partial sums of wo, the
# MLP and the experts reduced over the ranks in another order, and k / v
# projected on a rank's columns. Measured over both meshes: granite-moe
# 1.5e-5 (its own spread under one ulp on its embedding is 5.6e-5 to
# 1.2e-4, ROADMAP), the int8 llama 1.8e-5 (the dense smoke llama is held
# to 7e-5 split-KV, its one-ulp spread 6.9e-5, tests/test_torch_splitkv.py),
# the others within 1e-5
SELF_ATOL = {"granite-moe-1b-a400m": 5e-5, "qwen3-moe-235b-a22b": 1e-5,
             ENCDEC: 1e-5, VLM: 1e-5, INT8: 7e-5}
# the int8 cache end to end against one device's: k / v reach it through
# the rank's projections, last bits apart, so a code at a rounding tie
# moves by 1 (measured: at most 1) and a scale by a few ulps (relative)
CODE_STEP, SCALE_RTOL = 1, 1e-5
TEMPER = 0.25                 # seamless-m4t's wq, wk scale
MESHES = [(1, 2), (2, 2)]
B, S, STEPS, MAX_LEN, GEN = 4, 20, 6, 48, 6
FRAMES, FEW_FRAMES = 48, 12
MARGIN = 1e-3                 # the one-device greedy run's least top-2 gap


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(cfg, frames=FRAMES):
    """The prompt, the decode tokens and the family's conditioning: frame
    embeddings for the encoder-decoder, patch embeddings for the VLM."""
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    toks = rng.integers(0, cfg.vocab_size, (B, STEPS)).astype(np.int32)
    rows = frames if cfg.encdec else cfg.num_patches
    extra = (np.random.default_rng(2).normal(size=(B, rows, cfg.d_model))
             .astype(np.float32) if rows else None)
    return prompt, toks, extra


def _positions(t):
    if t < STEPS // 2:
        return S + t
    return np.asarray([S + t, S + t - 3, S + t - 1, S + t - 2], np.int32)


def _cfg(arch):
    from repro_torch.configs import smoke_config
    return smoke_config(arch).with_(**OVER.get(arch, {}))


def _port_params(cfg, tree):
    from repro_torch.models import (encdec_params_from_numpy,
                                    transformer_params_from_numpy)
    conv = (encdec_params_from_numpy if cfg.encdec
            else transformer_params_from_numpy)
    return conv(cfg, tree, "cpu")


class _Routes:
    """Records ``moe.route``'s (ids, rank, C) of every call while on."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.real, self.seen = moe, moe.route, []

    def __enter__(self):
        def route(*a, **kw):
            out = self.real(*a, **kw)
            self.seen.append((out[0].numpy(), out[2].numpy(), out[3]))
            return out
        self.moe.route = route
        return self.seen

    def __exit__(self, *exc):
        self.moe.route = self.real


def _run(model, params, prompt, toks, extra, rows=slice(None)):
    """Prefill and STEPS decode steps of ``rows``: (the logits of each,
    the cache after them)."""
    kw = {} if extra is None else {"extra": torch.as_tensor(extra[rows])}
    logits, cache = model.prefill(params, torch.as_tensor(prompt[rows]),
                                  MAX_LEN, **kw)
    out = [logits.numpy()]
    for t in range(STEPS):
        pos = _positions(t)
        pos = pos if isinstance(pos, int) else torch.as_tensor(pos[rows])
        logits, cache = model.decode_step(params, cache,
                                          torch.as_tensor(toks[rows, t:t + 1]),
                                          pos)
        out.append(logits.numpy())
    return out, cache


# ------------------------------------------------------------ rank bodies

def _zoo_rank(mesh, trees):
    """Every arch on this rank: the split-KV run (and its routing, its
    cache, its dummy heads), a greedy ``generate`` through ``ServeEngine``
    and, for the encoder-decoder, a 12-frame run; the sharded init, the
    expert-parallel MoE and the training forms."""
    from repro_torch.dist import splitkv
    from repro_torch.dist.collective_ops import batch_rows
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine, cache_shardings
    out = {}
    rows = batch_rows(mesh, B)
    real_attend = splitkv.attend
    for arch in ARCHS:
        cfg = _cfg(arch)
        model = build_model(cfg)
        whole = _port_params(cfg, trees[arch])
        meshed = model.with_mesh(mesh)
        params = splitkv.partition_transformer_params(whole, meshed, mesh)
        prompt, toks, extra = _inputs(cfg)
        dummy = []

        def attend(m, *a, **kw):
            o = real_attend(m, *a, **kw)
            hq = o.shape[2]
            g0 = m.tp.rank * hq if hq < m.h_eff else 0
            real = max(min(m.cfg.num_heads - g0, hq), 0)
            dummy.append((int(o[:, :, real:].count_nonzero()),
                          bool(o[:, :, :real].abs().amax(-1).gt(0).all())))
            return o
        splitkv.attend = attend
        try:
            with _Routes() as routes:
                steps, cache = _run(meshed, params, prompt, toks, extra, rows)
        finally:
            splitkv.attend = real_attend
        rec = dict(steps=steps, rows=(rows.start, rows.stop), routes=routes,
                   dummy=dummy,
                   segment=splitkv.cache_segment(mesh, MAX_LEN))
        if cfg.kv_quant:
            rec["cache"] = [{k: v.numpy() for k, v in layer.items()}
                            for layer in cache["layers"]]
            rec["cache_sh"] = {k: tuple(v) for k, v in cache_shardings(
                mesh, meshed, B, MAX_LEN)["layers"][0].items()}
        if cfg.encdec:
            rec["cross_rows"] = [layer["cross"]["k"].shape[1]
                                 for layer in cache["dec"]]
            few = _inputs(cfg, FEW_FRAMES)
            rec["few"] = _run(meshed, params, *few, rows)[0]
            rec["cross_sh"] = {k: tuple(v) for k, v in cache_shardings(
                mesh, meshed, B, MAX_LEN)["dec"][0]["cross"].items()}
        eng = ServeEngine(model, max_len=MAX_LEN, device="cpu", mesh=mesh)
        p, _ = eng.prepare(whole)
        rec["tokens"] = eng.generate(
            p, torch.as_tensor(prompt), GEN,
            extra=None if extra is None else torch.as_tensor(extra)).numpy()
        rec["dist"] = eng._dist
        out[arch] = rec
    out["init"] = _sharded_init(mesh)
    out["moe"] = _expert_parallel(mesh, trees[MOE[0]])
    out["train"] = _train_forms(mesh)
    return out


def _sharded_init(mesh):
    """Each arch's params drawn with ``shardings=``: (every piece bitwise
    the whole draw's slice, the rank's held bytes, ``launch.serve``'s
    figure for them, the whole params' bytes)."""
    from repro_torch.dist.collective_ops import shard_local
    from repro_torch.launch.serve import rank_param_bytes
    from repro_torch.models import build_model
    from repro_torch.models.layers import init_params
    from repro_torch.training.train_loop import param_shardings
    from repro_torch.training.tree import leaves
    out = {}
    for arch in ARCHS:
        model = build_model(_cfg(arch))
        sh = param_shardings(mesh, model)
        pieces = init_params(model.param_defs(),
                             torch.Generator().manual_seed(0), "cpu",
                             shardings=sh)
        whole = model.init(torch.Generator().manual_seed(0), "cpu")
        same = all(torch.equal(x.to_local(),
                               shard_local(w, mesh, s.placements))
                   for x, w, s in zip(leaves(pieces), leaves(whole),
                                      leaves(sh)))
        held = sum(x.to_local().untyped_storage().nbytes()
                   for x in leaves(pieces))
        out[arch] = (same, held, rank_param_bytes(model, sh),
                     rank_param_bytes(model))
    return out


def _expert_parallel(mesh, tree):
    """granite-moe's first MoE layer on one batch, its 8 experts split
    over ``model`` (expert parallelism), and the same config with 3
    experts, which ``model`` does not divide (the rule table splits the
    FFN's hidden dim instead, and the form gathers it): for each, (aux ==
    one device's, max |out - one device's|, the layout of ``w_up``)."""
    from repro_torch.dist.splitkv import partition_transformer_params
    from repro_torch.models import build_model
    from repro_torch.models.moe import moe_apply
    out = []
    for experts in (None, 3):
        cfg = _cfg(MOE[0])
        model = build_model(cfg)
        whole = _port_params(cfg, tree)
        if experts is not None:
            cfg = cfg.with_(num_experts=experts)
            model = build_model(cfg)
            whole = model.init(torch.Generator().manual_seed(3), "cpu")
        meshed = model.with_mesh(mesh)
        params = partition_transformer_params(whole, meshed, mesh)
        x = torch.as_tensor(np.random.default_rng(5).normal(
            size=(B, 9, cfg.d_model)).astype(np.float32))
        kw = dict(num_experts=cfg.num_experts, top_k=cfg.experts_per_token,
                  capacity_factor=cfg.capacity_factor,
                  activation=cfg.activation, group_size=cfg.moe_group)
        p = params["layers"][0]["moe"]
        y, aux = meshed.tp.moe(p, x, **kw)
        y1, aux1 = moe_apply(whole["layers"][0]["moe"], x, **kw)
        out.append((bool(torch.equal(aux, aux1)),
                    float((y - y1).abs().max()),
                    meshed.tp.split_dim(p["w_up"])))
    return out


def _train_forms(mesh):
    """``jit_train_step`` over a split model axis: the MoE, the
    encoder-decoder and the VLM each build their tensor-parallel step
    (None; an error's words where one does not)."""
    import types
    from repro_torch.models import build_model
    from repro_torch.training import OptConfig, jit_train_step
    toks = torch.zeros((4, 8), dtype=torch.long)
    said = {}
    for arch in (MOE[0], ENCDEC, VLM):
        try:
            jit_train_step(mesh, build_model(_cfg(arch)),
                           types.SimpleNamespace(grad_accum=1, zero1=True),
                           OptConfig(), {"tokens": toks, "labels": toks})
            said[arch] = None
        except NotImplementedError as e:
            said[arch] = str(e)
    return said


# ---------------------------------------------------------------- fixture

def _temper(tree):
    out = dict(tree)
    for blk in ("enc_blocks", "dec_blocks"):
        b = dict(out[blk])
        for att in ("attn", "xattn"):
            if att in b:
                b[att] = dict(b[att], wq=b[att]["wq"] * TEMPER,
                              wk=b[att]["wk"] * TEMPER)
        out[blk] = b
    return out


def _greedy(model, params, prompt, extra):
    """The one-device greedy run by hand: (tokens, the least top-2 gap of
    the logits that chose them)."""
    kw = {} if extra is None else {"extra": torch.as_tensor(extra)}
    logits, cache = model.prefill(params, torch.as_tensor(prompt), MAX_LEN,
                                  **kw)
    V = model.cfg.vocab_size
    toks, gap = [], float("inf")
    for t in range(GEN):
        top = torch.topk(logits[:, -1, :V], 2).values
        gap = min(gap, float((top[:, 0] - top[:, 1]).min()))
        tok = logits[:, -1, :V].argmax(-1)[:, None].to(torch.int32)
        toks.append(tok)
        if t + 1 < GEN:
            logits, cache = model.decode_step(params, cache, tok, S + t)
    return torch.cat(toks, 1).numpy(), gap


@pytest.fixture(scope="module")
def runs():
    """The reference's unsharded prefill and decode, the port's
    one-device run, routing, cache and greedy tokens, and both meshes'
    rank results (with the serve CLIs, all at once)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import smoke_config as jsmoke
    from repro.models import build_model as jbuild
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine
    trees, jnets, jparams = {}, {}, {}
    for arch in ARCHS:
        jnets[arch] = jbuild(jsmoke(arch).with_(**OVER.get(arch, {})))
        jp = jnets[arch].init(jax.random.key(0))
        jparams[arch] = _temper(jp) if arch == ENCDEC else jp
        trees[arch] = jax.tree.map(np.asarray, jparams[arch])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    clis = {a: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", a,
         "--mesh", "1,2", "--device", "cpu", "--smoke", "--batch", "2",
         "--prompt-len", "20", "--gen", "4"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for a in (MOE[0], ENCDEC, VLM)}
    with concurrent.futures.ThreadPoolExecutor(len(MESHES)) as pool:
        futs = {m: pool.submit(run_ranks, _zoo_rank, *m, args=(trees,))
                for m in MESHES}
        want = {}
        for arch in ARCHS:
            cfg = _cfg(arch)
            prompt, toks, extra = _inputs(cfg)
            kw = {} if extra is None else {"extra": jnp.asarray(extra)}
            # jitted: one compile a call shape (an int position goes in as
            # a 0-d array, which the reference reads as every row's)
            prefill = jax.jit(jnets[arch].prefill, static_argnums=(2,))
            decode = jax.jit(jnets[arch].decode_step)
            jl, jc = prefill(jparams[arch], jnp.asarray(prompt), MAX_LEN,
                             **kw)
            js = [np.asarray(jl, np.float32)]
            for t in range(STEPS):
                jl, jc = decode(jparams[arch], jc,
                                jnp.asarray(toks[:, t:t + 1]),
                                jnp.asarray(_positions(t), jnp.int32))
                js.append(np.asarray(jl, np.float32))
            model = build_model(cfg)
            params = _port_params(cfg, trees[arch])
            with _Routes() as routes:
                ts, cache = _run(model, params, prompt, toks, extra)
            rec = dict(ref=js, port=ts, routes=routes)
            if cfg.kv_quant:
                rec["cache"] = [{k: v.numpy() for k, v in layer.items()}
                                for layer in cache["layers"]]
            if cfg.encdec:
                rec["few"] = _run(model, params, *_inputs(cfg, FEW_FRAMES))[0]
            rec["greedy"], rec["gap"] = _greedy(model, params, prompt, extra)
            eng = ServeEngine(model, max_len=MAX_LEN, device="cpu")
            rec["tokens"] = eng.generate(
                params, torch.as_tensor(prompt), GEN,
                extra=None if extra is None else torch.as_tensor(extra)
            ).numpy()
            want[arch] = rec
        ranks = {m: f.result() for m, f in futs.items()}
    cli = {a: (p.wait(timeout=600), p.stdout.read()) for a, p in clis.items()}
    return dict(want=want, ranks=ranks, cli=cli)


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_zoo_decode_matches_reference(runs, mesh, arch):
    """Prefill and every decode step's logits on every rank's rows: within
    the zoo's tolerance of the reference's unsharded ``decode_step`` and
    within ``SELF_ATOL`` of the port's own."""
    want = runs["want"][arch]
    V = _cfg(arch).vocab_size
    for rk in runs["ranks"][mesh]:
        got = rk[arch]
        lo, hi = got["rows"]
        for t, g in enumerate(got["steps"]):
            np.testing.assert_allclose(g[..., :V], want["ref"][t][lo:hi,
                                                                  ..., :V],
                                       rtol=0, atol=REF_ATOL[arch],
                                       err_msg=str(t))
            np.testing.assert_allclose(g, want["port"][t][lo:hi], rtol=0,
                                       atol=SELF_ATOL[arch], err_msg=str(t))


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_moe_routing_exact(runs, mesh, arch):
    """Every MoE call of the sharded run (each layer of the prefill and
    of each step) routes the rank's rows as one device does: expert ids,
    ranks and the drop set (rank ≥ C) exact."""
    want = runs["want"][arch]["routes"]
    for rk in runs["ranks"][mesh]:
        got = rk[arch]["routes"]
        lo, hi = rk[arch]["rows"]
        assert len(got) == len(want) == _cfg(arch).num_layers * (STEPS + 1)
        for (ids, rank, c), (wids, wrank, wc) in zip(got, want):
            assert c == wc
            assert np.array_equal(ids, wids[lo:hi])
            assert np.array_equal(rank, wrank[lo:hi])
            assert np.array_equal(rank >= c, wrank[lo:hi] >= wc)


def test_int8_segment_writes_bitwise():
    """The split-KV writers of the int8 cache (the prompt's rows kept at
    each segment, then one row a step at an int and at per-row positions)
    on the same k / v: every segment's codes and scales bitwise the
    one-device cache's (``kv_cache_update``) at its positions, a segment
    the steps do not reach left as the prompt wrote it."""
    from repro_torch.dist.splitkv import _keep_prompt, write_segment
    from repro_torch.models import attention as A
    from repro_torch.models.layers import init_params
    g = torch.Generator().manual_seed(4)
    Bq, H, D, ML, P, seg = 3, 2, 16, 24, 9, 6
    defs = lambda n: A.kv_cache_defs(Bq, n, H, D, torch.float32, quant=True)
    whole = init_params(defs(ML), None, torch.device("cpu"))
    segs = [init_params(defs(seg), None, torch.device("cpu"))
            for _ in range(ML // seg)]
    k, v = (torch.randn(Bq, P, H, D, generator=g) for _ in range(2))
    A.kv_cache_update(whole, k, v, 0)
    for j, c in enumerate(segs):
        _keep_prompt(c, k, v, j * seg)
    for pos in (P, torch.tensor([P + 1, 5, ML - 1], dtype=torch.int32)):
        k, v = (torch.randn(Bq, 1, H, D, generator=g) for _ in range(2))
        A.kv_cache_update(whole, k, v, pos)
        p = torch.full((Bq,), pos) if isinstance(pos, int) else pos
        for j, c in enumerate(segs):
            write_segment(c, k, v, p, j * seg)
    for j, c in enumerate(segs):
        for name, leaf in c.items():
            assert torch.equal(leaf, whole[name][:, j * seg:(j + 1) * seg])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_int8_segments_match_one_device(runs, mesh):
    """llama3.2-3b's int8 cache end to end: each rank's segment of int8
    codes and float32 scales after the prefill and every step against the
    one-device cache's at its positions (codes within CODE_STEP, scales
    within SCALE_RTOL: the k / v written differ in their last bits); its
    scales split over ``cache_seq`` like the codes."""
    from torch.distributed.tensor import Shard
    want = runs["want"][INT8]["cache"]
    for rk in runs["ranks"][mesh]:
        got = rk[INT8]
        lo, hi = got["rows"]
        s0, s1 = got["segment"]
        for g, w in zip(got["cache"], want):
            assert sorted(g) == ["k", "k_scale", "v", "v_scale"]
            for name in g:
                x, y = g[name], w[name][lo:hi, s0:s1]
                assert x.dtype == y.dtype
                if x.dtype == np.int8:
                    assert np.abs(x.astype(np.int32)
                                  - y.astype(np.int32)).max() <= CODE_STEP
                else:
                    np.testing.assert_allclose(x, y, rtol=SCALE_RTOL, atol=0)
        assert set(got["cache_sh"].values()) == {(Shard(0), Shard(1))}


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_zoo_generate_tokens_equal_one_device(runs, mesh):
    """Greedy ``ServeEngine.generate`` under the mesh: the whole batch's
    tokens, on every rank, equal to one device's, whose own greedy run
    chose each token by a top-2 gap of at least MARGIN; the engine
    partitioned the params."""
    for arch in ARCHS:
        want = runs["want"][arch]
        assert want["gap"] >= MARGIN, (arch, want["gap"])
        assert np.array_equal(want["tokens"], want["greedy"])
        for rk in runs["ranks"][mesh]:
            assert rk[arch]["dist"]
            assert np.array_equal(rk[arch]["tokens"], want["tokens"]), arch


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_padded_heads_give_zero(runs, mesh):
    """llava's 64 stored q heads (4 real): in every attention call of the
    sharded run the rank's dummy heads are exactly 0 and its real heads'
    rows are not; at (1, 2) rank 1's block is dummy heads only."""
    for rk in runs["ranks"][mesh]:
        calls = rk[VLM]["dummy"]
        assert len(calls) == _cfg(VLM).num_layers * (STEPS + 1)
        assert all(nz == 0 and live for nz, live in calls)


def test_empty_segments_in_the_run(runs):
    """At (1, 2): the first decode steps read S + 1..3 positions, all on
    rank 0, so rank 1's self segment has no live key there; 48 frames
    over enc_len 64 leave rank 1 16 live cross rows, 12 frames none. The
    logits still match one device's (an empty segment weighs 0)."""
    r0, r1 = runs["ranks"][(1, 2)]
    assert r1[ENCDEC]["segment"][0] >= S + STEPS // 2
    assert r0[ENCDEC]["cross_rows"][0] == 32
    assert r1[ENCDEC]["cross_rows"][0] == FRAMES - 32
    for mesh in MESHES:
        for rk in runs["ranks"][mesh]:
            lo, hi = rk[ENCDEC]["rows"]
            for g, w in zip(rk[ENCDEC]["few"], runs["want"][ENCDEC]["few"]):
                np.testing.assert_allclose(g, w[lo:hi], rtol=0,
                                           atol=SELF_ATOL[ENCDEC])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_encdec_cache_shardings(runs, mesh):
    """The cross memory's k and v split over ``data`` on the batch and
    over ``model`` on ``cache_seq``, as the reference declares them."""
    from torch.distributed.tensor import Shard
    for rk in runs["ranks"][mesh]:
        assert rk[ENCDEC]["cross_sh"] == {"k": (Shard(0), Shard(1)),
                                          "v": (Shard(0), Shard(1))}


def test_merge_of_cross_segments_is_the_whole():
    """The cross memory of F rows cut into segments of enc_len / 4 (the
    last ones part-live or empty): each non-causal segment's plain B14
    over its live rows with ``lse``, merged, equals B14 over the whole
    memory."""
    from repro_torch.dist.splitkv import merge
    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(3)
    Bq, H, D, enc_len, F = 3, 4, 16, 64, 37
    q = torch.randn(Bq, H, D, generator=g)
    k = torch.randn(Bq, H, F, D, generator=g)
    v = torch.randn(Bq, H, F, D, generator=g)
    full = torch.full((Bq,), F, dtype=torch.int32)
    whole = ref.decode_attention_window_ref(q, k, v, full)
    seg = enc_len // 4
    os_, ls = [], []
    for j in range(4):
        n = min(max(F - j * seg, 0), seg)
        lse = torch.full((Bq, H), float("-inf"))
        o = torch.zeros(Bq, H, D)
        if n:
            o = ref.decode_attention_window_ref(
                q, k[:, :, j * seg:j * seg + n], v[:, :, j * seg:j * seg + n],
                torch.full((Bq,), n, dtype=torch.int32), lse=lse)
        os_.append(o)
        ls.append(lse)
    assert torch.isinf(ls[-1]).all()
    got = merge(torch.stack(os_), torch.stack(ls))
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_init_holds_pieces(runs, mesh):
    """``init_params(shardings=)``: every piece bitwise the whole draw's
    slice, the rank's held bytes its pieces' (``launch.serve``'s
    ``rank_param_bytes``), less than the whole params where ``model``
    splits them."""
    for rk in runs["ranks"][mesh]:
        for arch, (same, held, share, whole) in rk["init"].items():
            assert same, arch
            assert held == share < whole, (arch, held, share, whole)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_expert_parallel_moe(runs, mesh):
    """``TensorParallel.moe`` on the rank's experts (``w_up`` split on
    its expert dim), and with 3 experts (split on its hidden dim,
    gathered): aux bitwise one device's, the output within SELF_ATOL."""
    for rk in runs["ranks"][mesh]:
        (aux8, err8, dim8), (aux3, err3, dim3) = rk["moe"]
        assert (dim8, dim3) == (0, 2)
        assert aux8 and err8 <= SELF_ATOL[MOE[0]], err8
        assert aux3 and err3 <= SELF_ATOL[MOE[0]], err3


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_zoo_training_still_refuses(runs, mesh):
    """What the sharded train step once refused over a split ``model``
    axis it now takes: the MoE, the encoder-decoder and the VLM train
    tensor-parallel on their mesh forms (their gradients:
    tests/test_torch_tp_train_zoo.py)."""
    for rk in runs["ranks"][mesh]:
        assert len(rk["train"]) == 3
        for arch, said in rk["train"].items():
            assert said is None, (arch, said)


@pytest.mark.parametrize("arch", [MOE[0], ENCDEC, VLM])
def test_serve_cli_mesh_zoo(runs, arch):
    """``launch.serve --arch ARCH --smoke --mesh 1,2 --device cpu`` runs
    end to end on two spawned ranks, each rank drawing its pieces."""
    rc, text = runs["cli"][arch]
    assert rc == 0, text[-3000:]
    assert "mesh: data=1 model=2 over 2 ranks, gloo" in text
    assert "this rank's pieces" in text
    assert "generated (2, 4)" in text


@pytest.mark.parametrize("argv,match", [
    (["--arch", "recurrentgemma-9b"], "recurrent"),
    (["--arch", "rwkv6-7b"], "recurrent"),
    (["--arch", "granite-moe-1b-a400m", "--continuous"], "scheduler"),
    (["--arch", "seamless-m4t-medium", "--continuous"], "scheduler"),
    (["--arch", "llama3.2-3b", "--traffic"], "scheduler"),
], ids=["rglru", "rwkv", "moe-continuous", "encdec-continuous",
        "traffic"])
def test_serve_mesh_zoo_refusals(argv, match, capsys):
    """What ``--mesh`` refused until the recurrent families and the
    scheduler were sharded it now takes: its checks give the mesh's (data,
    model) and print nothing (``match``: the path each case opens; the
    runs: tests/test_torch_splitkv_recurrent.py,
    tests/test_torch_sched_mesh.py)."""
    from repro_torch.launch import serve
    argv = argv + ["--mesh", "1,2", "--smoke", "--device", "cpu"]
    ap = serve.parser()
    args = ap.parse_args(argv)
    assert serve._mesh_shape(ap, args) == (1, 2)
    assert not capsys.readouterr().err
    from repro_torch.configs import smoke_config
    cfg = smoke_config(args.arch)
    if match == "recurrent":
        assert set(cfg.block_pattern) & {"rec", "rwkv"}
    else:
        assert args.continuous or args.traffic

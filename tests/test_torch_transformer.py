"""The port's dense-transformer serving path on the CPU against the JAX
reference on the same weights: ``TransformerLM`` prefill / decode /
forward logits and KV cache, greedy ``ServeEngine`` tokens dense and
``transformer_policy``-pruned, the policy's masks, RoPE at far positions,
the rewind contract, greedy speculation with an LSTM draft, the CLI, and
the package's import isolation. Parameters are made by the reference
(``model.init(jax.random.key(0))``) and crossed with
``transformer_params_from_numpy``."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.models import LSTMConfig as JLSTMConfig, LSTMModel as JLSTMModel
from repro.models import build_model as j_build
from repro.models import layers as JL
from repro.models.attention import kv_cache_update as j_kv_cache_update
from repro.serving import ServeEngine as JEngine
from repro.sparse import transformer_policy as j_transformer_policy
from repro_torch.configs import ARCH_NAMES, get_arch, smoke_config
from repro_torch.models import (LSTMConfig, LSTMModel, build_model,
                                params_from_numpy,
                                transformer_params_from_numpy)
from repro_torch.models import layers as TL
from repro_torch.models.attention import kv_cache_update
from repro_torch.serving import ServeEngine
from repro_torch.spec import DraftModel, rollback, verify_chain
from repro_torch.sparse import classify, transformer_policy

# float32 logits, the frameworks rounding their sums in other orders. The
# smoke llama3.2-3b and minitron-8b have no qk-norm: their k reaches |34|
# and their attention scores ~100, so the model amplifies a last-bit
# difference anywhere: the reference itself moves its logits by ~7e-5
# when the last bit of half its embedding entries moves
# (test_last_bit_sensitivity), and 1e-5 is out of reach for any other
# float32 implementation (measured up to 1.1e-4 on logits of |2.9|).
# qwen3-0.6b normalizes q and k and stays within 1e-5 (measured 2.1e-6).
ATOL = {"qwen3-0.6b": 1e-5, "llama3.2-3b": 5e-4, "minitron-8b": 5e-4}
# the port's gap may be this many times the reference's own spread under
# a one-ulp change of its embedding (llama3.2-3b at S=16: gap 6.8e-5,
# spread 6.9e-5; qwen3-0.6b: 1.7e-6 and 1.4e-6)
ULP_SPREAD_FACTOR = 4
# the KV cache's k and v are not unit scale (|x| up to 42): qwen3 within
# 5e-5, 1.3e-6 of its magnitude (measured 2.0e-5 at S=1088); the others
# within 2e-3 (measured 3.8e-4 and 5.7e-4 at S=1088), as their logits
CACHE_ATOL = {"qwen3-0.6b": 5e-5, "llama3.2-3b": 2e-3, "minitron-8b": 2e-3}
# bf16 smoke qwen3-0.6b: each framework rounds activations to bf16 after
# its own float32 sums, and a one-ulp difference (2^-7 relative) carries
# through two layers: logits of |3.3| within 0.1 (measured 0.023)
BF16_ATOL = 0.1
# greedy parity is asserted at prompt seeds whose smallest top-2 margin is
# at least 10x the logits' tolerance (checked in the test)
GREEDY_SEED = {"qwen3-0.6b": 6, "llama3.2-3b": 7}
MAX_LEN = 40
ROOT = Path(__file__).resolve().parents[1]


def _setup(arch, dtype="float32"):
    jcfg = j_smoke(arch).with_(dtype=dtype)
    cfg = smoke_config(arch).with_(dtype=dtype)
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    params = transformer_params_from_numpy(
        cfg, jax.tree.map(np.asarray, jparams), "cpu")
    return dict(jcfg=jcfg, cfg=cfg, jmodel=jmodel, model=build_model(cfg),
                jparams=jparams, params=params)


@pytest.fixture(scope="module", params=["qwen3-0.6b", "llama3.2-3b"])
def net(request):
    return _setup(request.param)


@pytest.fixture(scope="module")
def qwen():
    return _setup("qwen3-0.6b")


def _np(x):
    return np.asarray(x, np.float32)


def _close(got, want, atol):
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=0,
                               atol=atol)


def _prompt(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _margins(logits):
    top2 = logits.topk(2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def test_param_tree_layout(net):
    """The per-layer list holds the reference's stacked blocks in order,
    dtypes kept; the port's param defs declare the same shapes."""
    cfg, params, jparams = net["cfg"], net["params"], net["jparams"]
    assert len(params["layers"]) == cfg.num_layers
    for i, layer in enumerate(params["layers"]):
        np.testing.assert_array_equal(
            layer["attn"]["wq"].numpy(),
            np.asarray(jparams["blocks"][0]["attn"]["wq"][i]))
    shapes = jax.tree.map(lambda a: tuple(a.shape), params)
    defs = net["model"].param_defs()
    assert shapes["layers"][0]["mlp"]["w_gate"] == \
        defs["layers"][0]["mlp"]["w_gate"].shape
    assert params["embed"]["table"].shape == (net["model"].vocab_padded,
                                              cfg.d_model)
    assert net["model"].param_count() == net["jmodel"].param_count()


@pytest.mark.parametrize("S", [16, 1088])
def test_prefill_logits_and_cache_match(net, S):
    """S ≤ 1024: the reference's full_attention; S = 1088: its
    blocked_attention (block 64). The port runs both through B15's plain
    version."""
    cfg, atol = net["cfg"], ATOL[net["cfg"].name]
    prompt = _prompt(cfg, 2, S, seed=S)
    ml = S + 8
    jl, jc = net["jmodel"].prefill(net["jparams"], jnp.asarray(prompt), ml)
    tl, tc = net["model"].prefill(net["params"], torch.as_tensor(prompt), ml)
    assert tl.shape == (2, 1, net["model"].vocab_padded)
    _close(tl, jl, atol)
    for i, layer in enumerate(tc["layers"]):
        for name in ("k", "v"):
            _close(layer[name], jc["blocks"][0]["mix"][name][i],
                   CACHE_ATOL[cfg.name])


def test_forward_logits_match(net):
    cfg = net["cfg"]
    prompt = _prompt(cfg, 2, 24, seed=5)
    jl, _ = net["jmodel"].forward(net["jparams"], jnp.asarray(prompt))
    logits, aux = net["model"].forward(net["params"], torch.as_tensor(prompt))
    _close(logits, jl, ATOL[cfg.name])
    assert aux == 0.0


def test_last_bit_sensitivity(net):
    """Why llama3.2-3b is held to 5e-4 and not 1e-5: moving the last bit
    of half the embedding's entries moves the reference's own logits past
    1e-5 there (not on qwen3-0.6b), and the port's gap is of the size of
    that spread."""
    cfg, jp = net["cfg"], net["jparams"]
    prompt = jnp.asarray(_prompt(cfg, 2, 16, seed=16))
    jl, _ = net["jmodel"].prefill(jp, prompt, 24)
    table = np.asarray(jp["embed"]["table"])
    bump = np.random.default_rng(0).random(table.shape) < 0.5
    moved = dict(jp, embed=dict(jp["embed"], table=jnp.asarray(
        np.where(bump, np.nextafter(table, np.float32(np.inf)), table))))
    jl2, _ = net["jmodel"].prefill(moved, prompt, 24)
    spread = float(jnp.abs(jl2 - jl).max())
    tl, _ = net["model"].prefill(net["params"], torch.as_tensor(
        np.asarray(prompt)), 24)
    gap = float(np.abs(tl.float().numpy() - _np(jl)).max())
    if cfg.name == "qwen3-0.6b":
        assert spread < 1e-5 and gap < 1e-5
    else:
        assert spread > 1e-5
        assert gap <= ULP_SPREAD_FACTOR * spread


@pytest.mark.parametrize("per_row", [False, True])
def test_decode_steps_match(net, per_row):
    """Eight decode steps after a prefill: a scalar pos (the slice write),
    or a (B,) pos whose rows sit at different positions (the per-row
    scatter)."""
    cfg, atol = net["cfg"], ATOL[net["cfg"].name]
    S, B = 12, 2
    prompt = _prompt(cfg, B, S, seed=1)
    _, jc = net["jmodel"].prefill(net["jparams"], jnp.asarray(prompt),
                                  MAX_LEN)
    _, tc = net["model"].prefill(net["params"], torch.as_tensor(prompt),
                                 MAX_LEN)
    toks = _prompt(cfg, B, 8, seed=2)
    for t in range(8):
        if per_row:
            jpos = jnp.asarray([S + t, S - 3 + t], jnp.int32)
            tpos = torch.tensor([S + t, S - 3 + t], dtype=torch.int32)
        else:
            jpos, tpos = S + t, S + t
        jl, jc = net["jmodel"].decode_step(net["jparams"], jc,
                                           jnp.asarray(toks[:, t:t + 1]),
                                           jpos)
        tl, tc = net["model"].decode_step(net["params"], tc,
                                          torch.as_tensor(toks[:, t:t + 1]),
                                          tpos)
        _close(tl, jl, atol)
    for i, layer in enumerate(tc["layers"]):
        _close(layer["k"], jc["blocks"][0]["mix"]["k"][i],
               CACHE_ATOL[cfg.name])


def test_minitron_layernorm_sq_relu_matches():
    """minitron-8b's smoke config: layernorm and the squared-ReLU MLP."""
    n = _setup("minitron-8b")
    prompt = _prompt(n["cfg"], 2, 10, seed=3)
    jl, jc = n["jmodel"].prefill(n["jparams"], jnp.asarray(prompt), 16)
    tl, tc = n["model"].prefill(n["params"], torch.as_tensor(prompt), 16)
    _close(tl, jl, ATOL["minitron-8b"])
    jl, _ = n["jmodel"].decode_step(n["jparams"], jc,
                                    jnp.asarray(prompt[:, :1]), 10)
    tl, _ = n["model"].decode_step(n["params"], tc,
                                   torch.as_tensor(prompt[:, :1]), 10)
    _close(tl, jl, ATOL["minitron-8b"])


def test_bf16_smoke_logits_match():
    n = _setup("qwen3-0.6b", "bfloat16")
    assert n["params"]["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    prompt = _prompt(n["cfg"], 2, 20, seed=4)
    jl, jc = n["jmodel"].prefill(n["jparams"], jnp.asarray(prompt), MAX_LEN)
    tl, tc = n["model"].prefill(n["params"], torch.as_tensor(prompt),
                                MAX_LEN)
    assert tc["layers"][0]["k"].dtype == torch.bfloat16
    _close(tl, jl, BF16_ATOL)
    for t in range(4):
        tok = prompt[:, t:t + 1]
        jl, jc = n["jmodel"].decode_step(n["jparams"], jc, jnp.asarray(tok),
                                         20 + t)
        tl, tc = n["model"].decode_step(n["params"], tc,
                                        torch.as_tensor(tok), 20 + t)
        _close(tl, jl, BF16_ATOL)


def test_greedy_generate_matches(net):
    """Greedy tokens are identical, at a seed whose per-step top-2 margin
    is asserted to be 10x the logits' tolerance."""
    cfg = net["cfg"]
    prompt, steps = _prompt(cfg, 3, 8, seed=GREEDY_SEED[cfg.name]), 10
    jeng = JEngine(net["jmodel"], net["jcfg"], max_len=MAX_LEN, batch=3)
    eng = ServeEngine(net["model"], max_len=MAX_LEN, device="cpu")
    want = np.asarray(jeng.generate(net["jparams"], jnp.asarray(prompt),
                                    steps))
    got, state = eng.generate(net["params"], torch.as_tensor(prompt), steps,
                              return_state=True)
    seq = torch.cat([torch.as_tensor(prompt), got.long()], 1)
    logits = net["model"].forward(net["params"], seq)[0][:, 7:-1]
    assert float(_margins(logits).min()) > 10 * ATOL[cfg.name]
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(state["pos"]) == 8 + steps
    with pytest.raises(TypeError, match="length"):
        eng.generate(net["params"], torch.as_tensor(prompt), 2,
                     lengths=[8, 5, 3])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_policy_masks_match_reference(dtype):
    """``transformer_policy`` on the port's per-layer paths gives the
    per-layer slices of the reference's stacked masks. bf16 magnitudes tie
    often: the stable tie-break decides those."""
    n = _setup("qwen3-0.6b", dtype)
    jplan = j_transformer_policy(0.75, 0.5).compile(n["jparams"])
    plan = transformer_policy(0.75, 0.5).compile(n["params"])
    jmasks = jplan.masks(n["jparams"])
    masks = plan.masks(n["params"])
    L = n["cfg"].num_layers
    assert len(masks) == 7 * L and len(jmasks) == 7
    ties = 0
    for jpath, jm in jmasks.items():
        leaf = jpath.split("/", 2)[2]               # e.g. attn/wq
        for i in range(L):
            m = masks[f"layers/{i}/{leaf}"]
            np.testing.assert_array_equal(m.numpy(), np.asarray(jm[i]))
            w = n["params"]["layers"][i]
            for part in leaf.split("/"):
                w = w[part]
            a = w.abs().float().flatten()
            ties += int(a.numel() - torch.unique(a).numel())
    if dtype == "bfloat16":
        assert ties > 1000        # the tie-break is exercised
    site = plan.sites["layers/0/attn/wq"]
    assert (site.d_in, site.d_out) == (128 * 4, 32)
    assert classify("layers/3/mlp/w_up") == "a"
    assert classify("layers/3/attn/wo") == "b"
    assert classify("layers/3/attn/q_norm") is None


def test_brds_pruned_greedy_matches(qwen):
    """``--brds``: prepare prunes the transformer (no packing) and greedy
    decoding of the pruned weights gives the reference's tokens."""
    prompt, steps = _prompt(qwen["cfg"], 2, 8, seed=7), 8
    jeng = JEngine(qwen["jmodel"], qwen["jcfg"], max_len=MAX_LEN, batch=2,
                   sparsity=j_transformer_policy(0.75, 0.5))
    eng = ServeEngine(qwen["model"], max_len=MAX_LEN, device="cpu",
                      sparsity=transformer_policy(0.75, 0.5))
    jpruned, jrep = jeng.prepare(qwen["jparams"])
    pruned, rep = eng.prepare(qwen["params"])
    assert rep == jrep and rep["sparsity"] > 0.5
    np.testing.assert_array_equal(
        pruned["layers"][1]["mlp"]["w_down"].numpy(),
        np.asarray(jpruned["blocks"][0]["mlp"]["w_down"][1]))
    want = np.asarray(jeng.generate(jpruned, jnp.asarray(prompt), steps))
    got = eng.generate(pruned, torch.as_tensor(prompt), steps)
    np.testing.assert_array_equal(got.numpy(), want)


def test_kv_cache_update_matches_reference():
    """Scalar positions (an int or a 0-d tensor) clamp so the rows fit
    (dynamic_update_slice); a (B,) position past the cache drops its row
    (the scatter's default). The port writes in place."""
    rng = np.random.default_rng(8)
    cache = rng.normal(size=(3, 6, 2, 4)).astype(np.float32)
    new = rng.normal(size=(3, 2, 2, 4)).astype(np.float32)
    cases = [(1, 1, 2), (5, 5, 2), (5, torch.tensor(5), 2),
             (np.array([0, 5, 9], np.int32), torch.tensor([0, 5, 9]), 1)]
    for jpos, tpos, n in cases:
        jc = j_kv_cache_update({"k": jnp.asarray(cache),
                                "v": jnp.asarray(cache)},
                               jnp.asarray(new[:, :n]),
                               jnp.asarray(new[:, :n]), jpos)
        tc = {"k": torch.from_numpy(cache.copy()),
              "v": torch.from_numpy(cache.copy())}
        out = kv_cache_update(tc, torch.from_numpy(new[:, :n]),
                              torch.from_numpy(new[:, :n]), tpos)
        assert out is tc
        for name in ("k", "v"):
            np.testing.assert_array_equal(tc[name].numpy(),
                                          np.asarray(jc[name]))


def test_rope_far_positions_match():
    """RoPE at positions up to 32767: the float32 frequency tables are
    identical, so the error does not grow with the position; what differs
    is cos / sin in the last bit (measured max 4.8e-7 on unit inputs)."""
    half = 64
    jf = np.asarray(1e6 ** (-jnp.arange(0, half, dtype=jnp.float32) / half))
    tf = TL.rope_freqs(half, 1e6)
    np.testing.assert_array_equal(tf.numpy(), jf)
    pos = np.arange(32768)[None]
    x = np.random.default_rng(9).normal(size=(1, 32768, 2, 128)).astype(
        np.float32)
    got = TL.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    want = JL.rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    err = np.abs(got.numpy() - np.asarray(want))
    assert float(err.max()) < 2e-6
    # no growth: the far quarter is as close as the near one
    assert float(err[:, -8192:].max()) < 4 * float(err[:, :8192].max()) \
        + 1e-6


def test_rewind_decode_matches_fresh_from_prefill(qwen):
    """The rewind contract (tests/test_spec.py): decode 3 tokens, roll
    back, decode different ones — bitwise the fresh trajectory. The KV
    cache rewinds by position alone (the rejected rows stay, dead)."""
    model, params, cfg = qwen["model"], qwen["params"], qwen["cfg"]
    B, S = 2, 5
    prompt = torch.as_tensor(_prompt(cfg, B, S, seed=10))
    A = torch.as_tensor(_prompt(cfg, B, 3, seed=11))
    Bt = torch.as_tensor(_prompt(cfg, B, 3, seed=12))
    pos = torch.full((B,), S, dtype=torch.int32)
    _, cache = model.prefill(params, prompt, MAX_LEN)
    _, cache_a, states = verify_chain(model, params, cache, A, pos)
    assert states == ()                     # every leaf is positional
    cache_r = rollback(model, cache_a, states, torch.zeros(B))
    got, _, _ = verify_chain(model, params, cache_r, Bt, pos)
    _, cache2 = model.prefill(params, prompt, MAX_LEN)
    want, _, _ = verify_chain(model, params, cache2, Bt, pos)
    assert torch.equal(got, want)
    # partial rewind: keep A's first token, replace the tail
    _, cache = model.prefill(params, prompt, MAX_LEN)
    _, cache_a, states = verify_chain(model, params, cache, A, pos)
    cache_r = rollback(model, cache_a, states, torch.ones(B))
    got, _, _ = verify_chain(model, params, cache_r, Bt, pos + 1)
    _, cache2 = model.prefill(params, prompt, MAX_LEN)
    want, _, _ = verify_chain(model, params, cache2,
                              torch.cat([A[:, :1], Bt], 1), pos)
    assert torch.equal(got, want[:, 1:])


def _lstm_draft(vocab):
    """The reference test's draft (1 layer, X=16, H=32, seed 1) in both
    packages."""
    kw = dict(input_size=16, hidden=32, num_layers=1, vocab_size=vocab)
    jd = JLSTMModel(JLSTMConfig("d", **kw))
    jdp = jd.init(jax.random.key(1))
    d = LSTMModel(LSTMConfig("d", **kw))
    return d, params_from_numpy(jax.tree.map(np.asarray, jdp), "cpu")


@pytest.mark.parametrize("k", [1, 3])
def test_greedy_spec_lossless_transformer_target(qwen, k):
    """An LSTM draft speculating for the KV-cache transformer: the tokens
    of target-only greedy decode, and the reference's."""
    d, dparams = _lstm_draft(qwen["cfg"].vocab_size)
    prompt = _prompt(qwen["cfg"], 2, 5, seed=13)
    eng = ServeEngine(qwen["model"], max_len=32, device="cpu")
    base = eng.generate(qwen["params"], torch.as_tensor(prompt), 6)
    spec, st = eng.generate(qwen["params"], torch.as_tensor(prompt), 6,
                            draft=DraftModel(d, dparams), spec_k=k,
                            return_state=True)
    assert torch.equal(base, spec) and int(st["rounds"].min()) >= 1
    jeng = JEngine(qwen["jmodel"], qwen["jcfg"], max_len=32, batch=2)
    want = np.asarray(jeng.generate(qwen["jparams"], jnp.asarray(prompt), 6))
    np.testing.assert_array_equal(spec.numpy(), want)


def test_spec_with_a_padded_target_vocabulary():
    """A target whose logits are padded (vocab 500 → 512) speculates with a
    draft bound to the logits' width; the tokens are target-only's. (The
    reference's CLI binds the draft to the unpadded vocabulary, and its
    spec loop then fails on the width mismatch.)"""
    cfg = smoke_config("qwen3-0.6b").with_(vocab_size=500)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    d = LSTMModel(LSTMConfig("d", input_size=16, hidden=32,
                             vocab_size=model.vocab_padded))
    draft = DraftModel(d, d.init(torch.Generator().manual_seed(1), "cpu"))
    prompt = torch.as_tensor(_prompt(cfg, 2, 5, seed=14))
    eng = ServeEngine(model, max_len=32, device="cpu")
    base = eng.generate(params, prompt, 6)
    assert int(base.max()) < 500
    assert torch.equal(base, eng.generate(params, prompt, 6, draft=draft,
                                          spec_k=3))


def test_unsupported_configs_raise():
    """Every config name is known and every one builds (the
    encoder-decoder as ``EncDecLM``); an unknown block kind raises
    naming it; the int8 KV cache declares int8 codes and float32 scales,
    all positional; a KV-cache model cannot draft."""
    from repro_torch.models import EncDecLM, TransformerLM
    assert len(ARCH_NAMES) == 10
    for name in ARCH_NAMES:
        cfg = smoke_config(name)
        assert get_arch(name).name == name
        model = build_model(cfg)
        assert isinstance(model, EncDecLM if cfg.encdec else TransformerLM)
    with pytest.raises(ValueError, match="unknown block kinds"):
        build_model(smoke_config("qwen3-0.6b").with_(block_pattern=("ssm",)))
    model = build_model(smoke_config("qwen3-0.6b").with_(kv_quant=True))
    layer = model.cache_defs(2, 8)["layers"][0]
    assert {k: d.dtype for k, d in layer.items()} == {
        "k": torch.int8, "v": torch.int8, "k_scale": torch.float32,
        "v_scale": torch.float32}
    assert layer["k_scale"].shape == (2, 8, 2, 1)
    from repro_torch.spec.verify import cache_leaf_flags
    positional, batch_axes = cache_leaf_flags(model)
    assert all(positional) and set(batch_axes) == {0}
    with pytest.raises(TypeError, match="positional"):
        DraftModel(model, None)            # a KV-cache model cannot draft


def test_serve_cli_on_cpu(capsys):
    from repro_torch.launch import serve
    base = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu", "--batch",
            "2", "--prompt-len", "6", "--gen", "4"]
    serve.main(base)
    plain = capsys.readouterr().out
    assert "arch=qwen3-0.6b" in plain and "init " in plain
    assert "generated (2, 4)" in plain
    serve.main(base + ["--brds", "--profile"])
    out = capsys.readouterr().out
    assert "BRDS:" in out and "profile: wall" in out
    serve.main(base + ["--draft", "lstm_ptb", "--draft-brds", "--spec-k",
                       "4"])
    out = capsys.readouterr().out
    assert "spec: acceptance=" in out
    ids = [ln for ln in out.splitlines() if ln.startswith("sample ids:")]
    assert ids == [ln for ln in plain.splitlines()
                   if ln.startswith("sample ids:")]


@pytest.mark.parametrize("argv,reason", [
    (["--arch", "rwkv6-7b", "--scorecard"], "rwkv"),
    (["--arch", "granite-moe-1b-a400m", "--scorecard"], "LSTM-only"),
    (["--arch", "qwen3-0.6b", "--delta", "0"], "LSTM-only"),
    (["--arch", "qwen3-0.6b", "--brds", "--quant", "int8"], "LSTM-only"),
])
def test_serve_cli_rejects_what_the_port_lacks(capsys, argv, reason):
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.main(["--smoke", "--device", "cpu", *argv])
    assert reason in capsys.readouterr().err


def test_transformer_path_imports_no_jax():
    """The transformer path (configs, model, serve CLI) pulls in neither
    JAX nor the reference package, and builds no kernel."""
    code = ("import sys, repro_torch.configs, repro_torch.models, "
            "repro_torch.models.transformer, repro_torch.launch.serve, "
            "repro_torch.kernels.flash_attention, "
            "repro_torch.kernels.decode_attention, "
            "repro_torch.kernels._build as b\n"
            "assert not b._libs\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env={**os.environ, "PYTHONPATH": str(ROOT / "src")})

"""The port's recurrent families on the CPU against the JAX reference on
the same inputs: ``models/recurrent.py`` function by function (RG-LRU's
scan and step, RWKV6's chunked time mix, its step and channel mix, the
packed projection), then recurrentgemma-9b's and rwkv6-7b's smoke models
(``configs.smoke_config``: d 128, window 32, rwkv chunk 16) with the
reference's weights carried across by ``transformer_params_from_numpy``:
prefill and decode logits and state with prompts past the window and the
chunk, greedy tokens, ``forward`` / ``loss`` and every gradient leaf,
``transformer_policy``'s masks on the ``rec/*`` and ``rwkv/*`` leaves,
and rwkv6-7b as a speculative target with an LSTM draft."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.core.packing import pack as j_pack
from repro.models import LSTMConfig as JLSTMConfig, LSTMModel as JLSTMModel
from repro.models import build_model as j_build
from repro.models import layers as JL
from repro.models import recurrent as JR
from repro.serving import ServeEngine as JEngine
from repro.sparse import transformer_policy as j_transformer_policy
from repro_torch.configs import smoke_config
from repro_torch.core.packing import pack
from repro_torch.models import (LSTMConfig, LSTMModel, build_model,
                                params_from_numpy,
                                transformer_params_from_numpy)
from repro_torch.models import recurrent as R
from repro_torch.serving import ServeEngine
from repro_torch.serving.runtime import leaves
from repro_torch.sparse import transformer_policy
from repro_torch.spec import DraftModel
from repro_torch.spec.verify import cache_leaf_flags
from repro_torch.training import train_loop

FAMILIES = ("recurrentgemma-9b", "rwkv6-7b")
# float32 logits of the smoke models. The RG-LRU hybrid amplifies a
# last-bit difference anywhere: moving the last bit of half the
# reference's embedding entries moves its own logits by up to 2.3e-4
# (test_last_bit_sensitivity), and the port's gap is of that size
# (measured up to 3.2e-4 over six prompts, 45 tokens, six decode steps).
# rwkv6-7b's chunked time mix sums in another order (measured up to
# 2.5e-5). Each bound is at most 10x the measured value (ROADMAP.md C).
ATOL = {"recurrentgemma-9b": 1e-3, "rwkv6-7b": 1e-4}
# every gradient leaf, relative to the leaf's largest entry (measured
# 5.8e-4 and 1.1e-5)
GRAD_RTOL = {"recurrentgemma-9b": 2e-3, "rwkv6-7b": 1e-4}
LOSS_RTOL = 2e-6        # measured 3.5e-7 and 6.9e-8
# the functions alone, relative to the output's largest entry: RWKV6's
# time mix sums the pairwise decays over d in another order (measured
# 1.8e-6 of |y| ~ 40), its state the chunk's outer products (2.1e-6)
FN_RTOL = 1e-5
# prompt seeds whose every greedy step's top-2 margin is at least 10x the
# logits' bound (asserted where used)
GREEDY_SEED = {"recurrentgemma-9b": 0, "rwkv6-7b": 0}
PROMPT = 45             # past the window (32) and two chunks (16)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x, np.float32)


def _t(tree):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), _np(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _setup(arch, dtype="float32"):
    jcfg = j_smoke(arch).with_(dtype=dtype)
    cfg = smoke_config(arch).with_(dtype=dtype)
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    params = transformer_params_from_numpy(
        cfg, jax.tree.map(np.asarray, jparams), "cpu")
    return dict(jcfg=jcfg, cfg=cfg, jmodel=jmodel, model=build_model(cfg),
                jparams=jparams, params=params)


@pytest.fixture(scope="module", params=FAMILIES)
def net(request):
    return _setup(request.param)


def _prompt(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


# ------------------------------------------------------------- functions

def _rglru_params(rng, d=64, dr=64, W=4):
    jp = dict(JL.init_params(JR.rglru_defs(d, dr, W, jnp.float32),
                             jax.random.key(1)))
    jp["lam"] = jnp.asarray(rng.uniform(-1, 2, dr).astype(np.float32))
    jp["conv_b"] = jnp.asarray(rng.normal(0, 0.1, dr).astype(np.float32))
    return jp, _t(jp)


@pytest.mark.parametrize("n", [1, 2, 7, 16, 45])
def test_associative_scan_is_the_reference_recursion(n):
    """h_t = a_t h_{t-1} + b_t by the log-depth recursion: bitwise the
    reference's eager ``jax.lax.associative_scan`` at even and odd
    lengths."""
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (2, n, 8)).astype(np.float32)
    b = rng.normal(size=(2, n, 8)).astype(np.float32)

    def comb(l, r):
        return l[0] * r[0], r[0] * l[1] + r[1]

    ja, jb = jax.lax.associative_scan(comb, (jnp.asarray(a), jnp.asarray(b)),
                                      axis=1)
    ta, tb = R.associative_scan(R._combine, (torch.tensor(a),
                                             torch.tensor(b)), dim=1)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_apply_and_step_match(with_state):
    """``rglru_apply`` over 45 tokens (from zeros, or chained from a
    state), its new state, and ``rglru_step`` from that state."""
    rng = np.random.default_rng(0)
    jp, tp = _rglru_params(rng)
    x = rng.normal(size=(2, 45, 64)).astype(np.float32)
    st = None
    if with_state:
        st = {"h": rng.normal(size=(2, 64)).astype(np.float32),
              "conv": rng.normal(size=(2, 3, 64)).astype(np.float32)}
    jy, js = JR.rglru_apply(jp, jnp.asarray(x),
                            None if st is None else jax.tree.map(
                                jnp.asarray, st))
    ty, ts = R.rglru_apply(tp, torch.tensor(x),
                           None if st is None else _t(st))
    assert _rel(ty, jy) < FN_RTOL
    np.testing.assert_allclose(ts["h"].numpy(), _np(js["h"]), atol=1e-6)
    np.testing.assert_array_equal(ts["conv"].numpy(), _np(js["conv"]))
    x1 = rng.normal(size=(2, 1, 64)).astype(np.float32)
    jy1, js1 = JR.rglru_step(jp, jnp.asarray(x1), js)
    ty1, ts1 = R.rglru_step(tp, torch.tensor(x1), ts)
    assert _rel(ty1, jy1) < FN_RTOL
    for k in ("h", "conv"):
        np.testing.assert_allclose(ts1[k].numpy(), _np(js1[k]), atol=1e-6)


def _rwkv_params(rng, d=128, H=4, Dk=32, ff=256):
    jp = dict(JL.init_params(JR.rwkv_defs(d, H, Dk, ff, jnp.float32),
                             jax.random.key(1)))
    for k in ("mu", "w0", "u", "gn", "mu_cm"):
        jp[k] = jnp.asarray(rng.uniform(-0.5, 0.5, jp[k].shape)
                            .astype(np.float32))
    return jp, _t(jp)


@pytest.mark.parametrize("S", [48, 40, 37])
def test_rwkv_time_mix_matches(S):
    """The chunked time mix at chunk 16 from a carried state: 3 chunks of
    16 (S=48), 4 of 10 (S=40: the largest divisor of S at most 16) and 37
    of 1 (S=37, prime); the new state S and x_tm."""
    rng = np.random.default_rng(S)
    jp, tp = _rwkv_params(rng)
    assert R._chunk_len(S, 16) == {48: 16, 40: 10, 37: 1}[S]
    x = rng.normal(size=(2, S, 128)).astype(np.float32)
    st = {"S": rng.normal(size=(2, 4, 32, 32)).astype(np.float32) * 0.1,
          "x_tm": rng.normal(size=(2, 128)).astype(np.float32)}
    jy, js = JR.rwkv_time_mix(jp, jnp.asarray(x),
                              jax.tree.map(jnp.asarray, st), chunk=16)
    ty, ts = R.rwkv_time_mix(tp, torch.tensor(x), _t(st), chunk=16)
    assert _rel(ty, jy) < FN_RTOL
    assert _rel(ts["S"], js["S"]) < FN_RTOL
    np.testing.assert_array_equal(ts["x_tm"].numpy(), _np(js["x_tm"]))


def test_rwkv_step_and_channel_mix_match():
    """``rwkv_time_mix_step`` from a state, and ``rwkv_channel_mix`` (the
    relu² FFN after a token shift) with its new state."""
    rng = np.random.default_rng(5)
    jp, tp = _rwkv_params(rng)
    st = {"S": rng.normal(size=(2, 4, 32, 32)).astype(np.float32) * 0.1,
          "x_tm": rng.normal(size=(2, 128)).astype(np.float32)}
    x1 = rng.normal(size=(2, 1, 128)).astype(np.float32)
    jy, js = JR.rwkv_time_mix_step(jp, jnp.asarray(x1),
                                   jax.tree.map(jnp.asarray, st))
    ty, ts = R.rwkv_time_mix_step(tp, torch.tensor(x1), _t(st))
    assert _rel(ty, jy) < FN_RTOL
    np.testing.assert_allclose(ts["S"].numpy(), _np(js["S"]), atol=1e-6)
    x = rng.normal(size=(2, 9, 128)).astype(np.float32)
    jy, jx = JR.rwkv_channel_mix(jp, jnp.asarray(x),
                                 jnp.asarray(st["x_tm"]))
    ty, tx = R.rwkv_channel_mix(tp, torch.tensor(x),
                                torch.tensor(st["x_tm"]))
    assert _rel(ty, jy) < 1e-6
    np.testing.assert_array_equal(tx.numpy(), _np(jx))


def test_packed_projection_matches():
    """``_proj`` on a row-balanced packed weight (the columns the deltas'
    running sum gives, a gather, a float32 product) against the
    reference's on the same mask, the dense product of the pruned weight
    alike; and ``_rwkv_out`` through a packed w_out."""
    rng = np.random.default_rng(2)
    w = rng.normal(size=(96, 128)).astype(np.float32)       # (rows, d_in)
    keep = np.zeros_like(w, bool)
    for r in range(96):
        keep[r, rng.choice(128, 24, replace=False)] = True
    jw, tw = j_pack(jnp.asarray(w), jnp.asarray(keep)), pack(
        torch.tensor(w), torch.tensor(keep))
    np.testing.assert_array_equal(tw.deltas.numpy(), np.asarray(jw.deltas))
    x = rng.normal(size=(2, 5, 128)).astype(np.float32)
    want = JR._proj(jnp.asarray(x), jw)
    got = R._proj(torch.tensor(x), tw)
    assert got.shape == (2, 5, 96)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5)
    dense = R._proj(torch.tensor(x), torch.tensor((w * keep).T.copy()))
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=1e-5)
    jp, tp = _rwkv_params(rng, d=96)
    o = rng.normal(size=(2, 5, 4, 32)).astype(np.float32)
    g = rng.normal(size=(2, 5, 4, 32)).astype(np.float32)
    jo = JR._rwkv_out(dict(jp, w_out=jw), jnp.asarray(o), jnp.asarray(g))
    to = R._rwkv_out(dict(tp, w_out=tw), torch.tensor(o), torch.tensor(g))
    np.testing.assert_allclose(to.numpy(), _np(jo), atol=1e-5)


# ---------------------------------------------------------------- models

def test_param_tree_and_cache_layout(net):
    """Layer l has kind ``block_pattern[l % P]`` and the reference's
    stacked leaves at its period; the param counts agree; the state leaves
    carry no ``cache_seq`` axis (spec.verify reads them as state), the
    hybrid's KV leaves do; in a bf16 config ``lam``, ``mu``, ``w0``,
    ``u`` and ``gn`` stay float32."""
    cfg, model, params = net["cfg"], net["model"], net["params"]
    P = len(cfg.block_pattern)
    assert model.param_count() == net["jmodel"].param_count()
    for i, (kind, layer) in enumerate(zip(model.kinds, params["layers"])):
        assert kind == cfg.block_pattern[i % P]
        key = {"rec": "rec", "rwkv": "rwkv"}.get(kind, "attn")
        assert key in layer and ("mlp" in layer) == (kind != "rwkv")
        jstack = net["jparams"]["blocks"][i % P][key]
        name = sorted(jstack)[0]
        np.testing.assert_array_equal(layer[key][name].numpy(),
                                      np.asarray(jstack[name][i // P]))
    positional, _ = cache_leaf_flags(model)
    kinds = [k for k in model.kinds
             for _ in range({"rec": 2, "rwkv": 3}.get(k, 2))]
    assert positional == [k.startswith("attn") for k in kinds]
    bf = _setup(cfg.name, "bfloat16")["params"]["layers"]
    for layer in bf:
        mixer = layer.get("rec") or layer.get("rwkv") or {}
        for name, leaf in mixer.items():
            f32 = name in ("lam", "mu", "w0", "u", "gn", "mu_cm")
            assert leaf.dtype == (torch.float32 if f32 else torch.bfloat16)


def test_prefill_and_decode_match(net):
    """A 45-token prompt (past the window and two chunks): prefill logits
    and every cache leaf, then six decode steps on the reference's greedy
    tokens (logits and cache); the greedy tokens are the same where every
    step's top-2 margin is at least 10x the bound (asserted)."""
    cfg, atol = net["cfg"], ATOL[net["cfg"].name]
    V = cfg.vocab_size
    prompt = _prompt(cfg, 2, PROMPT, GREEDY_SEED[cfg.name])
    ml = PROMPT + 8
    jl, jc = net["jmodel"].prefill(net["jparams"], jnp.asarray(prompt), ml)
    tl, tc = net["model"].prefill(net["params"], torch.as_tensor(prompt), ml)
    assert tl.shape == (2, 1, net["model"].vocab_padded)
    for s in range(7):
        np.testing.assert_allclose(tl[..., :V].numpy(), _np(jl)[..., :V],
                                   rtol=0, atol=atol)
        top2 = np.sort(_np(jl)[:, 0, :V], -1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > 10 * atol
        tok = np.argmax(_np(jl)[:, 0, :V], -1)[:, None].astype(np.int32)
        np.testing.assert_array_equal(
            tl[:, 0, :V].argmax(-1).numpy(), tok[:, 0])
        if s == 6:
            break
        jl, jc = net["jmodel"].decode_step(net["jparams"], jc,
                                           jnp.asarray(tok), PROMPT + s)
        tl, tc = net["model"].decode_step(net["params"], tc,
                                          torch.as_tensor(tok), PROMPT + s)
    # the reference's cache: blocks[i]["mix"] (+ "x_cm") per position,
    # stacked over periods
    P = len(cfg.block_pattern)
    for i, layer in enumerate(tc["layers"]):
        jb = jax.tree.map(lambda a: a[i // P], jc["blocks"][i % P])
        want = dict(jb["mix"], **({"x_cm": jb["x_cm"]} if "x_cm" in jb
                                  else {}))
        assert sorted(layer) == sorted(want)
        for name, leaf in layer.items():
            scale = max(float(np.abs(_np(want[name])).max()), 1.0)
            np.testing.assert_allclose(leaf.numpy(), _np(want[name]),
                                       rtol=0, atol=atol * scale,
                                       err_msg=f"layer {i} {name}")


def test_last_bit_sensitivity():
    """Why the hybrid is held to 1e-3 and not 1e-5: moving the last bit of
    half the embedding's entries moves the reference's own prefill logits
    of a 45-token prompt past 1e-4 (measured 2.3e-4)."""
    n = _setup("recurrentgemma-9b")
    jp = n["jparams"]
    prompt = jnp.asarray(_prompt(n["cfg"], 2, PROMPT, seed=1))
    jl, _ = n["jmodel"].prefill(jp, prompt, PROMPT + 8)
    table = np.asarray(jp["embed"]["table"])
    bump = np.random.default_rng(0).random(table.shape) < 0.5
    moved = dict(jp, embed=dict(jp["embed"], table=jnp.asarray(
        np.where(bump, np.nextafter(table, np.float32(np.inf)), table))))
    jl2, _ = n["jmodel"].prefill(moved, prompt, PROMPT + 8)
    V = n["cfg"].vocab_size
    assert float(jnp.abs(jl2 - jl)[..., :V].max()) > 1e-4


def test_greedy_generate_matches(net):
    """``ServeEngine.generate`` (the captured loop's body, eagerly on the
    CPU) gives the reference engine's greedy tokens, at a seed whose
    margins the previous test asserts."""
    cfg = net["cfg"]
    prompt = _prompt(cfg, 2, PROMPT, GREEDY_SEED[cfg.name])
    jeng = JEngine(net["jmodel"], net["jcfg"], max_len=PROMPT + 8, batch=2)
    want = np.asarray(jeng.generate(net["jparams"], jnp.asarray(prompt), 7))
    eng = ServeEngine(net["model"], max_len=PROMPT + 8, device="cpu")
    got, state = eng.generate(net["params"], torch.as_tensor(prompt), 7,
                              return_state=True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(state["pos"]) == PROMPT + 7


def test_loss_and_grads_match(net):
    """``loss`` (with a mask) and every gradient leaf against
    ``jax.value_and_grad``, through the training forward (plain PyTorch,
    the windowed train attention for ``attn_local``; remat per layer)."""
    cfg = net["cfg"]
    toks = _prompt(cfg, 2, PROMPT, seed=1)
    mask = (np.arange(PROMPT - 1)[None] < np.array([[44], [30]]))
    mask = mask.astype(np.float32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks),
          "mask": jnp.asarray(mask)}
    tb = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(toks),
          "mask": torch.as_tensor(mask)}
    jl, jg = jax.jit(jax.value_and_grad(net["jmodel"].loss))(net["jparams"],
                                                             jb)
    tl, tg = train_loop.value_and_grad(net["model"].loss, net["params"], tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    jgt = transformer_params_from_numpy(cfg, jax.tree.map(np.asarray, jg),
                                        "cpu")
    tol = GRAD_RTOL[cfg.name]
    for a, b in zip(leaves(tg), leaves(jgt)):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= tol * max(
            float(b.abs().max()), 1e-6)


def test_policy_masks_match_reference(net):
    """``transformer_policy``'s masks on the port's per-layer ``rec/*``
    and ``rwkv/*`` leaves (layouts ``in_out`` and ``out_trailing``) are
    the per-period slices of the reference's stacked ones."""
    cfg = net["cfg"]
    jmasks = j_transformer_policy(0.75, 0.5).compile(
        net["jparams"]).masks(net["jparams"])
    masks = transformer_policy(0.75, 0.5).compile(
        net["params"]).masks(net["params"])
    P = len(cfg.block_pattern)
    seen = set()
    for path, m in masks.items():
        _, i, leaf = path.split("/", 2)
        i = int(i)
        jm = jmasks[f"blocks/{i % P}/{leaf}"][i // P]
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
        seen.add(leaf.split("/")[0])
    assert len(masks) == sum(np.asarray(m).shape[0] for m in jmasks.values())
    assert seen == ({"rec", "attn", "mlp"} if cfg.name == "recurrentgemma-9b"
                    else {"rwkv"})


def test_rwkv_spec_target_with_lstm_draft_lossless():
    """rwkv6-7b as the target of an LSTM draft (k=3): the target-only
    greedy tokens, the reference engine's, rollback from the state
    checkpoints (no positional leaf)."""
    n = _setup("rwkv6-7b")
    cfg = n["cfg"]
    kw = dict(input_size=16, hidden=32, num_layers=1, vocab_size=512)
    jd = JLSTMModel(JLSTMConfig("d", **kw))
    jdp = jd.init(jax.random.key(1))
    draft = DraftModel(LSTMModel(LSTMConfig("d", **kw)), params_from_numpy(
        jax.tree.map(np.asarray, jdp), "cpu"))
    assert not any(cache_leaf_flags(n["model"])[0])
    prompt = _prompt(cfg, 2, 21, seed=2)
    eng = ServeEngine(n["model"], max_len=32, device="cpu")
    base = eng.generate(n["params"], torch.as_tensor(prompt), 8)
    spec, st = eng.generate(n["params"], torch.as_tensor(prompt), 8,
                            draft=draft, spec_k=3, return_state=True)
    assert torch.equal(base, spec) and int(st["rounds"].min()) >= 1
    jeng = JEngine(n["jmodel"], n["jcfg"], max_len=32, batch=2)
    want = np.asarray(jeng.generate(n["jparams"], jnp.asarray(prompt), 8))
    np.testing.assert_array_equal(spec.numpy(), want)

"""Training in the port (``repro_torch.training``, the models' ``loss``)
against the JAX reference on the same inputs: the corpora bitwise, the
optimizers' formulas, the LSTM's and the transformer's loss and every
gradient leaf, one and five train steps dense and masked, gradient
accumulation; plus the kernel wrappers' refusal of autograd and the
transformer's training forward never reaching B15."""
import importlib
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke_config
from repro.models import LSTMConfig as JConfig, LSTMModel as JModel
from repro.models import build_model as jbuild_model
from repro.sparse import lstm_policy as jlstm_policy
from repro.sparse import transformer_policy as jtransformer_policy
from repro.training import OptConfig as JOpt, init_state as jinit_state
from repro.training import make_train_step as jmake_train_step
from repro.training import data as jdata
from repro.training import optim as joptim
from repro_torch.configs import smoke_config
from repro_torch.kernels import (decode_attention, delta_rb_spmv,
                                 flash_attention, fused_scan, fused_step,
                                 ops, rb_spmv, rb_spmv_q8)
from repro_torch.models import (LSTMConfig, LSTMModel, build_model,
                                params_from_numpy,
                                transformer_params_from_numpy)
from repro_torch.models import attention as A
from repro_torch.sparse import lstm_policy, transformer_policy
from repro_torch.training import (OptConfig, init_state, make_train_step,
                                  data, optim)
from repro_torch.training import masked
from repro_torch.training import train_loop
from repro_torch.training.tree import leaves, leaves_with_keys
# the module, not the op the package re-exports under its name
lstm_gates_mod = importlib.import_module("repro_torch.kernels.lstm_gates")

LOSS_RTOL = 1e-6      # float32 losses, summation order (measured ≤ 2.3e-7)
GRAD_ATOL = 2e-7      # gradient leaves of max |g| ≤ 0.1 (measured ≤ 3.7e-8)
# params after AdamW steps at lr 1e-2: an update is lr·m̂/(√v̂ + 1e-8), so
# where |g| is within a few eps of 0 a last-bit difference in g moves it by
# a part of the rate (measured up to 3.0e-5 = 0.003 lr on 2 of 65536
# entries). Every entry is held to lr/100, and all but 0.1% of them to
# 1e-6 (measured ≤ 8.9e-7 after five steps)
PARAM_ATOL = 1e-4
PARAM_TIGHT, TIGHT_SHARE = 1e-6, 1e-3
KW = dict(input_size=24, hidden=32, num_layers=2, vocab_size=64)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # many tiny ops: torch's intra-op threads only contend here
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _lm(kind="lm"):
    kw = dict(KW)
    if kind == "frame":
        kw.update(vocab_size=0, num_classes=5, framewise=True)
    elif kind == "cls":
        kw.update(vocab_size=0, num_classes=3)
    jm, m = JModel(JConfig("t", **kw)), LSTMModel(LSTMConfig("t", **kw))
    jp = jm.init(jax.random.key(0))
    return jm, m, jp, params_from_numpy(_np(jp), "cpu")


def _batch(kind, step=0, B=4, T=12):
    if kind == "lm":
        raw = data.ZipfInduction(vocab_size=64).batch(step, B, T)
        x, y = raw["tokens"], raw["labels"]
    else:
        raw = data.FrameCorpus(input_size=24, num_classes=5).batch(step, B, T)
        x, y = raw["inputs"], raw["labels"]
        if kind == "cls":
            y = y[:, -1] % 3
    return ({"inputs": jnp.asarray(x), "labels": jnp.asarray(y)},
            {"inputs": torch.as_tensor(x), "labels": torch.as_tensor(y)})


def _close_params(t_tree, j_tree):
    """Params after optimizer steps (``PARAM_ATOL`` / ``PARAM_TIGHT``)."""
    _close_trees(t_tree, j_tree, atol=PARAM_ATOL, rtol=0)
    diff = np.concatenate([
        np.abs(t.float().numpy() - np.asarray(j, np.float32)).ravel()
        for t, j in zip(leaves(t_tree), jax.tree.leaves(j_tree))])
    assert (diff > PARAM_TIGHT).mean() <= TIGHT_SHARE, np.sort(diff)[-20:]


def _close_trees(t_tree, j_tree, atol, rtol=1e-5):
    jl = jax.tree.leaves(j_tree)
    tl = leaves(t_tree)
    assert len(jl) == len(tl)
    for (key, t), j in zip(leaves_with_keys(t_tree), jl):
        np.testing.assert_allclose(t.detach().float().numpy(),
                                   np.asarray(j, np.float32), atol=atol,
                                   rtol=rtol, err_msg=key)


# ----------------------------------------------------------------- data

CORPORA = [
    ("zipf", lambda m: m.ZipfInduction(vocab_size=97, seed=3), (5, 7, 19)),
    ("char", lambda m: m.CharCorpus(seed=2), (3, 4, 33)),
    ("frame", lambda m: m.FrameCorpus(input_size=20, num_classes=7, seed=1),
     (6, 5, 9)),
]


@pytest.mark.parametrize("name,make,shape", CORPORA,
                         ids=[c[0] for c in CORPORA])
def test_corpora_bitwise(name, make, shape):
    """Every batch, eval batch and shard is the reference's, bit for bit,
    and a fresh corpus (a restart) draws the same batch again."""
    step, B, T = shape
    ours, ref = make(data), make(jdata)
    for s in (0, step, 10_000):
        a, b = ours.batch(s, B, T), ref.batch(s, B, T)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(make(data).batch(s, B, T)[k],
                                          a[k])
    for a, b in zip(ours.eval_batches(2, B, T), ref.eval_batches(2, B, T)):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert data.EVAL_STEP_BASE == jdata.EVAL_STEP_BASE
    for i in range(2):
        a = data.ShardedLoader(ours, 4, T, shard_idx=i, num_shards=2)
        b = jdata.ShardedLoader(ref, 4, T, shard_idx=i, num_shards=2)
        for k, v in a.batch(step).items():
            np.testing.assert_array_equal(v, b.batch(step)[k])


def test_char_corpus_text_is_the_reference():
    assert data._CHAR_TEXT == jdata._CHAR_TEXT
    assert data.CharCorpus().stoi == jdata.CharCorpus().stoi


# ------------------------------------------------------------ optimizer

@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_at_matches(schedule):
    kw = dict(lr=0.3, warmup_steps=10, total_steps=100, min_lr_frac=0.1,
              schedule=schedule)
    for step in (0, 3, 10, 11, 55, 99, 100, 150):
        np.testing.assert_allclose(float(optim.lr_at(OptConfig(**kw), step)),
                                   float(joptim.lr_at(JOpt(**kw), step)),
                                   rtol=1e-6)


def test_clip_and_global_norm_match():
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(5, 3)).astype(np.float32) * 3,
            "b": [rng.normal(size=(7,)).astype(np.float32)]}
    tt = {"a": torch.as_tensor(tree["a"]),
          "b": [torch.as_tensor(tree["b"][0])]}
    np.testing.assert_allclose(float(optim.global_norm(tt)),
                               float(joptim.global_norm(tree)), rtol=1e-6)
    for max_norm in (0.5, 100.0):
        g, n = optim.clip_by_global_norm(tt, max_norm)
        jg, jn = joptim.clip_by_global_norm(tree, max_norm)
        np.testing.assert_allclose(float(n), float(jn), rtol=1e-6)
        _close_trees(g, jg, atol=1e-7, rtol=1e-6)
    _, _, m = optim.apply_update(OptConfig(grad_clip=1.0),
                                 {"x": torch.zeros(4)},
                                 {"x": torch.full((4,), 100.0)},
                                 init_state(OptConfig(),
                                            {"x": torch.zeros(4)}))
    assert float(m["grad_norm"]) == pytest.approx(200.0)


@pytest.mark.parametrize("name", ["adamw", "sgdm", "lion"])
def test_apply_update_matches(name):
    """One update on the same params, gradients and (nonzero) state, at a
    step past warm-up: params, moments, count and metrics."""
    rng = np.random.default_rng(1)
    mk = lambda s: rng.normal(size=s).astype(np.float32)
    p = {"w": mk((6, 4)), "b": mk((4,)), "layers": [mk((3, 3))]}
    g = {"w": mk((6, 4)) * 0.3, "b": mk((4,)), "layers": [mk((3, 3))]}
    kw = dict(name=name, lr=1e-2, warmup_steps=2, total_steps=20)
    jst = jinit_state(JOpt(**kw), p)
    jst = {**jst, **{k: jax.tree.map(lambda x: jnp.asarray(mk(x.shape)) ** 2,
                                     jst[k]) for k in ("m", "v") if k in jst},
           "count": jnp.int32(5)}
    conv = lambda t: jax.tree.map(lambda x: torch.tensor(np.asarray(x)), t)
    jp2, jst2, jm = joptim.apply_update(JOpt(**kw), p, g, jst)
    tp2, tst2, tm = optim.apply_update(OptConfig(**kw), conv(p), conv(g),
                                       conv(jst))
    _close_trees(tp2, jp2, atol=1e-7, rtol=1e-6)
    for k in jst2:
        if k == "count":
            assert int(tst2[k]) == int(jst2[k]) == 6
            assert tst2[k].dtype == torch.int32
        else:
            _close_trees(tst2[k], jst2[k], atol=1e-7, rtol=1e-6)
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)


@pytest.mark.parametrize("name", ["adamw", "sgdm", "lion"])
def test_optimizers_converge(name):
    oc = OptConfig(name=name, lr=0.05, weight_decay=0.0, warmup_steps=1,
                   total_steps=500, schedule="constant")
    t = torch.tensor([1.0, -2.0, 3.0])
    params = {"x": torch.zeros(3)}
    st = init_state(oc, params)
    for _ in range(300):
        g = {"x": 2 * (params["x"] - t)}
        params, st, _ = optim.apply_update(oc, params, g, st)
    assert float(((params["x"] - t) ** 2).sum()) < 1e-2


def test_bf16_params_update_in_float32():
    oc = OptConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    p = {"w": torch.ones(8, dtype=torch.bfloat16)}
    st = init_state(oc, p)
    assert st["m"]["w"].dtype == torch.float32
    p2, st2, _ = optim.apply_update(oc, p, {"w": p["w"] * 0.5}, st, step=3)
    assert p2["w"].dtype == torch.bfloat16
    assert st2["v"]["w"].dtype == torch.float32
    with pytest.raises(ValueError):
        init_state(OptConfig(name="adagrad"), p)


# ----------------------------------------------------------------- LSTM

@pytest.mark.parametrize("kind", ["lm", "frame", "cls"])
def test_lstm_loss_and_grads_match(kind):
    """``loss`` and every gradient leaf against ``jax.value_and_grad``: 2
    layers, X=24, H=32 (V=64 for the LM; framewise 5 classes; last-step
    3 classes)."""
    jm, m, jp, p = _lm(kind)
    jb, tb = _batch(kind)
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(jp, jb)
    tl, tg = train_loop.value_and_grad(m.loss, p, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    _close_trees(tg, jg, atol=GRAD_ATOL)
    jlog = jm.forward(jp, jb["inputs"])
    np.testing.assert_allclose(m.forward(p, tb["inputs"]).numpy(),
                               np.asarray(jlog), atol=1e-5)


@pytest.mark.parametrize("masked_", [False, True], ids=["dense", "masked"])
@pytest.mark.parametrize("n", [1, 5])
def test_lstm_train_steps_match(masked_, n):
    """n AdamW steps through ``make_train_step`` (steps 3.. : past the
    warm-up's zero rate), dense and masked by ``lstm_policy(0.75, 0.5)``:
    params, optimizer state and metrics against the reference's, and
    every pruned entry exactly 0 after every step in both packages."""
    jm, m, jp, p = _lm()
    jmasks = masks = None
    if masked_:
        jp, jmasks = jlstm_policy(0.75, 0.5).compile(jp).prune(jp)
        p, masks = lstm_policy(0.75, 0.5).compile(p).prune(p)
        for k, v in masks.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(jmasks[k]))
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    arch = types.SimpleNamespace(grad_accum=1)
    jstep = jax.jit(jmake_train_step(jm, arch, JOpt(**kw), jmasks))
    step = make_train_step(m, arch, OptConfig(**kw), masks)
    jst, st = jinit_state(JOpt(**kw), jp), init_state(OptConfig(**kw), p)
    for i in range(3, 3 + n):
        jb, tb = _batch("lm", step=i)
        jp, jst, jmet = jstep(jp, jst, jb, jnp.int32(i))
        p, st, met = step(p, st, tb, i)
        for k, v in (masks or {}).items():
            i_, key = k.split("/")[1:]
            w = p["layers"][int(i_)][key]
            jw = np.asarray(jp["layers"][int(i_)][key])
            assert not w[~v].any() and not jw[~np.asarray(v)].any()
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                       rtol=1e-5)
    assert not any(t.requires_grad for t in leaves(p))
    _close_params(p, jp)
    _close_trees(st["m"], jst["m"], atol=1e-7)
    _close_trees(st["v"], jst["v"], atol=1e-9)
    assert int(st["count"]) == int(jst["count"]) == n


def test_grad_accum_two_equals_one():
    """accum=2 over a split batch == accum=1 over the whole batch (the
    reference's check, on the LSTM), and == the reference's accum=2."""
    jm, m, jp, p = _lm()
    jb, tb = _batch("lm", B=8)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    outs = {}
    for accum in (1, 2):
        arch = types.SimpleNamespace(grad_accum=accum)
        outs[accum] = make_train_step(m, arch, OptConfig(**kw))(
            p, init_state(OptConfig(**kw), p), tb, 3)
    (p1, _, m1), (p2, _, m2) = outs[1], outs[2]
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)
    assert max(float((a - b).abs().max())
               for a, b in zip(leaves(p1), leaves(p2))) < 1e-5
    jp2, _, jm2 = jax.jit(jmake_train_step(
        jm, types.SimpleNamespace(grad_accum=2), JOpt(**kw)))(
        jp, jinit_state(JOpt(**kw), jp), jb, jnp.int32(3))
    np.testing.assert_allclose(float(m2["loss"]), float(jm2["loss"]),
                               rtol=LOSS_RTOL)
    _close_params(p2, jp2)


def test_mask_grads_both_forms():
    jm, m, jp, p = _lm()
    pruned, masks = m.prune(p, 0.75, 0.5)
    g = {**p, "layers": [{k: torch.ones_like(v) for k, v in lp.items()}
                         for lp in p["layers"]]}
    legacy = [{"w_x": masks[f"layers/{i}/w_x"],
               "w_h": masks[f"layers/{i}/w_h"]} for i in range(2)]
    jg = jax.tree.map(np.asarray, {**jp, "layers": [
        {k: jnp.ones_like(v) for k, v in lp.items()} for lp in jp["layers"]]})
    jmasks = {k: jnp.asarray(v.numpy()) for k, v in masks.items()}
    want = jm.mask_grads(jg, jmasks)
    plan = lstm_policy(0.75, 0.5).compile(p)
    for got in (m.mask_grads(g, masks), m.mask_grads(g, legacy),
                plan.mask_grads(g, masks)):
        _close_trees(got, want, atol=0)
    _close_trees(plan.apply_masks(p, masks), jm.mask_grads(_np(jp), jmasks),
                 atol=0)


def test_sparse_and_dense_step_match():
    """``sparse_step`` (chained, float and int8) and ``dense_step`` against
    the reference's on the same packing and inputs."""
    from repro.quant import QuantConfig as JQuant
    from repro_torch.quant import QuantConfig
    jm, m, jp, p = _lm()
    jpr, jmasks = jm.prune(jp, 0.75, 0.5)
    pr, masks = m.prune(p, 0.75, 0.5)
    x = np.random.default_rng(2).normal(size=(3, 24)).astype(np.float32)
    jstate = [(jnp.zeros((3, 32)), jnp.zeros((3, 32)))] * 2
    state = m.init_state(3, "cpu")
    jh, _ = jm.dense_step(jpr, jnp.asarray(x), jstate)
    h, _ = m.dense_step(pr, torch.as_tensor(x), state)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-6)
    for quant in (None, "int8"):
        jpk = jm.pack(jpr, jmasks, quant=quant and JQuant(quant))
        pk = m.pack(pr, masks, quant=quant and QuantConfig(quant))
        jh, jst = jm.sparse_step(jpk, jnp.asarray(x), jstate, backend="ref")
        h, st = m.sparse_step(pk, torch.as_tensor(x), state)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-5)
        np.testing.assert_allclose(st[1][0].numpy(), np.asarray(jst[1][0]),
                                   atol=1e-5)


def test_masked_shims_warn():
    cfg = smoke_config("qwen3-0.6b")
    params = build_model(cfg).init(device="cpu")
    with pytest.warns(DeprecationWarning, match="transformer_policy"):
        ms = masked.brds_masks(params, 0.75, 0.5)
    assert ms.keys() == transformer_policy(0.75, 0.5).compile(
        params).masks(params).keys()
    with pytest.warns(DeprecationWarning):
        packed, rep = masked.brds_pack_params(params, 0.75, 0.5)
    assert rep["packed_bytes"] < rep["dense_bytes"]
    from repro.training import masked as jmasked
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, abs_rep = masked.brds_pack_params(
            build_model(cfg).abstract_params(), 0.75, 0.5, abstract=True)
        _, jrep = jmasked.brds_pack_params(
            jbuild_model(jsmoke_config("qwen3-0.6b")).abstract_params(),
            0.75, 0.5, abstract=True)
    assert abs_rep == jrep == rep
    assert masked.sparsity_report(params, ms)["pruned"] > 0


def test_sharded_train_step_raises():
    """The shardings resolve on a mesh-shaped object (the reference's
    ``axis_names`` / ``devices.shape``); the sharded step itself needs a
    DeviceMesh of initialized ranks and raises on anything else (it runs
    in tests/test_torch_sharded_train.py)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty((2, 2)))
    model = LSTMModel(LSTMConfig("t", **KW))
    p_sh = train_loop.param_shardings(mesh, model)
    assert p_sh["layers"][0]["w_x"].placements == (Replicate(), Shard(0))
    assert p_sh["embed"]["table"].placements == (Replicate(), Shard(0))
    assert p_sh["head"]["w"].placements == (Replicate(), Shard(1))
    o_sh = train_loop.opt_shardings(mesh, OptConfig(), p_sh,
                                    model.param_defs())
    assert o_sh["m"]["layers"][0]["w_x"].placements == (Shard(1), Shard(0))
    assert o_sh["count"].placements == (Replicate(), Replicate())
    b_sh = train_loop.batch_shardings(mesh, {"inputs": torch.zeros(4, 3)})
    assert b_sh["inputs"].placements == (Shard(0), Replicate())
    with pytest.raises(TypeError, match="DeviceMesh"):
        train_loop.jit_train_step(mesh, model, types.SimpleNamespace(
            grad_accum=1), OptConfig(), {"inputs": torch.zeros(4, 3)})


# ---------------------------------------------------------- transformer

@pytest.fixture(scope="module")
def tnet():
    cfg, jcfg = smoke_config("qwen3-0.6b"), jsmoke_config("qwen3-0.6b")
    jm, m = jbuild_model(jcfg), build_model(cfg)
    jp = jm.init(jax.random.key(0))
    p = transformer_params_from_numpy(cfg, _np(jp), "cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 16))
    toks = toks.astype(np.int32)
    return dict(cfg=cfg, jm=jm, m=m, jp=jp, p=p, toks=toks)


def test_transformer_loss_and_grads_match(tnet, monkeypatch):
    """qwen3-0.6b's smoke config: ``loss`` (with and without a mask) and
    every gradient leaf against ``jax.value_and_grad``; the training
    forward never reaches B15 (its wrapper made to raise)."""
    def no_b15(*a, **k):
        raise AssertionError("the training forward reached B15")
    monkeypatch.setattr(ops, "flash_attention", no_b15)
    cfg, toks = tnet["cfg"], tnet["toks"]
    mask = (np.arange(15)[None] < np.array([[15], [9], [15], [4]]))
    for m_ in (None, mask.astype(np.float32)):
        jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
        tb = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(toks)}
        if m_ is not None:
            jb["mask"], tb["mask"] = jnp.asarray(m_), torch.as_tensor(m_)
        jl, jg = jax.jit(jax.value_and_grad(tnet["jm"].loss))(tnet["jp"],
                                                              jb)
        tl, tg = train_loop.value_and_grad(tnet["m"].loss, tnet["p"], tb)
        np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
        jgt = transformer_params_from_numpy(cfg, _np(jg), "cpu")
        _close_trees(tg, jgt, atol=GRAD_ATOL)


def test_transformer_train_step_and_remat(tnet):
    """One masked AdamW step of the smoke transformer against the
    reference's (``transformer_policy(0.75, 0.5)``); ``cfg.remat``
    (``torch.utils.checkpoint``) changes no bit of the gradients."""
    cfg, toks = tnet["cfg"], tnet["toks"]
    jp, jmasks = jtransformer_policy(0.75, 0.5).compile(tnet["jp"]).prune(
        tnet["jp"])
    p, masks = transformer_policy(0.75, 0.5).compile(tnet["p"]).prune(
        tnet["p"])
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    tb = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(toks)}
    jp2, _, jmet = jax.jit(jmake_train_step(tnet["jm"], cfg, JOpt(**kw),
                                            jmasks))(
        jp, jinit_state(JOpt(**kw), jp), jb, jnp.int32(3))
    p2, _, met = make_train_step(tnet["m"], cfg, OptConfig(**kw), masks)(
        p, init_state(OptConfig(**kw), p), tb, 3)
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=LOSS_RTOL)
    _close_params(p2, transformer_params_from_numpy(cfg, _np(jp2), "cpu"))
    for path, mk in masks.items():
        node = p2
        for k in path.split("/"):
            node = node[int(k)] if k.isdigit() else node[k]
        assert not node[~mk].any()
    assert cfg.remat
    _, g_remat = train_loop.value_and_grad(tnet["m"].loss, p, tb)
    plain = build_model(cfg.with_(remat=False))
    _, g_plain = train_loop.value_and_grad(plain.loss, p, tb)
    for a, b in zip(leaves(g_remat), leaves(g_plain)):
        assert torch.equal(a, b)


def test_blocked_attention_matches():
    """The blocked online softmax (S past max(block_q, 1024) in training)
    and the full masked softmax against the reference's; the two alike;
    ``train_attention`` takes the blocked one only past 1024 rows."""
    from repro.models import attention as JA
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(2, 64, 4, 16)).astype(np.float32)
               for _ in range(3))
    want = JA.blocked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), block_q=16, block_kv=32)
    got = A.blocked_attention(*map(torch.as_tensor, (q, k, v)), block_q=16,
                              block_kv=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    full = A.train_attention(*map(torch.as_tensor, (q, k, v)), block_q=16,
                             block_kv=32)          # S = 64: the full softmax
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=1e-6)
    np.testing.assert_allclose(
        full.numpy(), np.asarray(JA.full_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))), atol=1e-6)
    calls = []
    orig = A.blocked_attention
    try:
        A.blocked_attention = lambda *a, **kw: calls.append(1) or orig(*a,
                                                                        **kw)
        for S in (1024, 1088):
            x = torch.zeros(1, S, 2, 8)
            A.train_attention(x, x[:, :, :1], x[:, :, :1], block_q=64,
                              block_kv=64)
    finally:
        A.blocked_attention = orig
    assert calls == [1]


# ---------------------------------------------- kernels refuse autograd

def _rg(*shape, dtype=torch.float32):
    return torch.zeros(*shape, dtype=dtype).requires_grad_(
        dtype.is_floating_point)


WRAPPERS = {
    "rb_spmv": lambda: rb_spmv.rb_spmv(_rg(4, 2), torch.zeros(4, 2,
                                       dtype=torch.int16), _rg(1, 8), 4),
    "rb_dual_spmv": lambda: rb_spmv.rb_dual_spmv(
        _rg(4, 2), torch.zeros(4, 2), _rg(1, 8), _rg(4, 2),
        torch.zeros(4, 2), _rg(1, 4), _rg(4)),
    "lstm_gates": lambda: lstm_gates_mod.lstm_gates(
        _rg(1, 2), _rg(1, 2), _rg(1, 2), _rg(1, 2), _rg(1, 2)),
    "fused_brds_lstm_step": lambda: fused_step.fused_brds_lstm_step(
        *[torch.zeros(8, 2)] * 2, _rg(1, 8), *[torch.zeros(8, 2)] * 2,
        _rg(1, 2), _rg(8), _rg(1, 2)),
    "delta_rb_spmv": lambda: delta_rb_spmv.delta_rb_spmv(
        torch.zeros(4, 2), torch.zeros(4, 2), _rg(1, 8), _rg(1, 8), 4),
    "delta_rb_dual_spmv": lambda: delta_rb_spmv.delta_rb_dual_spmv(
        *[torch.zeros(4, 2)] * 2, _rg(1, 8), _rg(1, 8),
        *[torch.zeros(4, 2)] * 2, _rg(1, 4), _rg(1, 4), _rg(1, 4)),
    "fused_brds_delta_lstm_step":
        lambda: fused_step.fused_brds_delta_lstm_step(
            *[torch.zeros(8, 2)] * 2, _rg(1, 8), _rg(1, 8),
            *[torch.zeros(8, 2)] * 2, _rg(1, 2), _rg(1, 2), _rg(1, 8), _rg(8),
            _rg(1, 2)),
    "rb_spmv_q8": lambda: rb_spmv_q8.rb_spmv_q8(
        torch.zeros(4, 4, dtype=torch.int8), torch.zeros(4, 4), _rg(4),
        torch.zeros(1, 8, dtype=torch.int8), 4),
    "rb_dual_parts_q8": lambda: rb_spmv_q8.rb_dual_parts_q8(
        torch.zeros(4, 4, dtype=torch.int8), torch.zeros(4, 4), _rg(4),
        torch.zeros(1, 8, dtype=torch.int8),
        torch.zeros(4, 4, dtype=torch.int8), torch.zeros(4, 4), _rg(4),
        torch.zeros(1, 8, dtype=torch.int8), 4),
    "fused_brds_lstm_step_q8": lambda: fused_step.fused_brds_lstm_step_q8(
        torch.zeros(8, 4, dtype=torch.int8), torch.zeros(8, 4), _rg(8),
        torch.zeros(1, 8, dtype=torch.int8),
        torch.zeros(8, 4, dtype=torch.int8), torch.zeros(8, 4), _rg(8),
        torch.zeros(1, 2, dtype=torch.int8), _rg(8), _rg(1, 2)),
    "fused_brds_delta_lstm_step_q8":
        lambda: fused_step.fused_brds_delta_lstm_step_q8(
            torch.zeros(8, 4, dtype=torch.int8), torch.zeros(8, 4), _rg(8),
            torch.zeros(1, 8, dtype=torch.int8),
            torch.zeros(8, 4, dtype=torch.int8), torch.zeros(8, 4), _rg(8),
            torch.zeros(1, 2, dtype=torch.int8), _rg(1, 8), _rg(8),
            _rg(1, 2)),
    "fused_brds_lstm_scan": lambda: fused_scan.fused_brds_lstm_scan(
        *[torch.zeros(8, 2)] * 2, _rg(3, 1, 8), *[torch.zeros(8, 2)] * 2,
        _rg(1, 2), _rg(8), _rg(1, 2)),
    "fused_brds_delta_lstm_scan":
        lambda: fused_scan.fused_brds_delta_lstm_scan(
            *[torch.zeros(8, 2)] * 2, _rg(3, 1, 8), *[torch.zeros(8, 2)] * 2,
            _rg(1, 2), _rg(1, 2), _rg(1, 8), _rg(1, 2), _rg(1, 8), _rg(8),
            theta_x=0.0, theta_h=0.0),
    "decode_attention": lambda: decode_attention.decode_attention(
        _rg(1, 2, 32), _rg(1, 1, 4, 32), _rg(1, 1, 4, 32),
        torch.ones(1, dtype=torch.int32)),
    "flash_attention": lambda: flash_attention.flash_attention(
        _rg(1, 2, 4, 32), _rg(1, 1, 4, 32), _rg(1, 1, 4, 32)),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_kernel_wrapper_refuses_autograd(name):
    """Every one of the fifteen kernel wrappers raises at once on an
    operand that requires grad with grad mode on (the kernels have no
    backward); under ``torch.no_grad()`` the same call goes on to the
    device checks (a CPU tensor is refused as not on the card)."""
    with pytest.raises(RuntimeError, match="no backward"):
        WRAPPERS[name]()
    with torch.no_grad():
        with pytest.raises((ValueError, TypeError), match="CUDA"):
            WRAPPERS[name]()


def test_fifteen_wrappers():
    from repro_torch.kernels._build import LAUNCHES
    assert sorted(WRAPPERS) == sorted(LAUNCHES)

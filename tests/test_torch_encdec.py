"""The port's encoder-decoder (``models/encdec.py``, seamless-m4t-medium's
smoke config: 2 encoder and 2 decoder layers, d 128, 4 heads of 32) on the
CPU against the JAX reference's ``EncDecLM`` on the same weights
(``encdec_params_from_numpy``) and inputs made with numpy: ``encode``,
prefill with frames (the cross memory cached), decode steps over it,
``forward``, ``loss`` and every gradient leaf, ``transformer_policy``'s
masks on the per-layer ``enc_blocks`` / ``dec_blocks`` paths,
``generate(extra=frames)`` against the reference engine, and the
scheduler with frames of ``enc_len`` rows against B=1.

The reference's init makes this model's attention near one-hot: ``wq``
and ``wk`` take fan-in = the head count (4 at smoke width), q and k reach
a standard deviation of ~5.7 and the scores ~31, so one ulp on the
reference's own frames moves its logits by up to 0.06
(``test_last_bit_sensitivity``). The logits are held on the same model
with every attention's ``wq`` and ``wk`` scaled by 1/4 (scores ~2; both
sides take the same params), where the reference's own spread under one
ulp on every weight is 7e-6 to 1.2e-5 and the port's gap 3e-6 to 9e-6;
at the reference's init the port's gap is held to 4x that spread."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.models import build_model as j_build
from repro.serving import ServeEngine as JEngine
from repro.sparse import transformer_policy as j_transformer_policy
from repro_torch.configs import smoke_config
from repro_torch.models import EncDecLM, build_model, encdec_params_from_numpy
from repro_torch.serving import ServeEngine
from repro_torch.serving.runtime import leaves
from repro_torch.serving.scheduler import ContinuousBatchingEngine
from repro_torch.sparse import transformer_policy
from repro_torch.spec.verify import cache_leaf_flags
from repro_torch.training import train_loop

ARCH = "seamless-m4t-medium"
# float32 logits (tempered attention; measured ≤ 8.9e-6), the encoder's
# memory (measured ≤ 2e-6 of |x| ~4) and the caches' k and v
ATOL = 5e-5
GRAD_RTOL = 1e-4          # each leaf, of its largest entry
LOSS_RTOL = 2e-6
SPREAD_FACTOR = 4         # at the reference's init: gap ≤ 4x its spread
TEMPER = 0.25             # wq, wk scale of the held comparison
PROMPT, MAX_LEN, FRAMES = 21, 32, 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x, np.float32)


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


@functools.lru_cache(maxsize=None)
def _setup(temper=True, **over):
    """The reference's model and seed-0 weights and the port's on them,
    made once a module (no test changes them)."""
    jcfg, cfg = j_smoke(ARCH).with_(**over), smoke_config(ARCH).with_(**over)
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    if temper:
        jparams = _temper(jparams)
    params = encdec_params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                      "cpu")
    return dict(jcfg=jcfg, cfg=cfg, jmodel=jmodel, model=build_model(cfg),
                jparams=jparams, params=params)


@pytest.fixture(scope="module")
def net():
    return _setup()


def _inputs(cfg, B=2, S=24, seed=0, frames=FRAMES):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    fr = np.random.default_rng(seed + 100).normal(
        size=(B, frames, cfg.d_model)).astype(np.float32)
    return toks, fr


def test_param_tree_and_cache_layout(net):
    """``enc_blocks`` / ``dec_blocks`` are per-layer lists of the
    reference's stacked leaves; the param counts agree; every cache leaf
    (self and cross) is positional, the cross memory ``enc_len`` rows."""
    model, params = net["model"], net["params"]
    assert isinstance(model, EncDecLM)
    assert model.param_count() == net["jmodel"].param_count()
    for k, n in (("enc_blocks", 2), ("dec_blocks", 2)):
        assert len(params[k]) == n
        for i, layer in enumerate(params[k]):
            np.testing.assert_array_equal(
                layer["attn"]["wq"].numpy(),
                np.asarray(net["jparams"][k]["attn"]["wq"][i]))
    assert sorted(params["dec_blocks"][0]) == [
        "attn", "mlp", "norm1", "norm2", "norm_x", "xattn"]
    positional, _ = cache_leaf_flags(model)
    assert all(positional) and len(positional) == 2 * 4
    layer = model.cache_defs(2, MAX_LEN)["dec"][0]
    assert layer["cross"]["k"].shape == (2, net["cfg"].enc_len, 2, 32)
    assert layer["self"]["k"].shape == (2, MAX_LEN, 2, 32)


def test_encode_matches(net):
    """The encoder's memory: ``frame_proj``, the bidirectional stack (B15's
    plain version without a causal mask; the training form alike), the
    final norm."""
    _, fr = _inputs(net["cfg"])
    want = _np(net["jmodel"].encode(net["jparams"], jnp.asarray(fr)))
    for train in (False, True):
        got = net["model"].encode(net["params"], torch.as_tensor(fr),
                                  train=train)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_prefill_decode_and_forward_match(net, seed):
    """Prefill of a 21-token prompt over 16 frames: the logits, each
    layer's self cache and cross memory (16 rows: the frames the prefill
    encoded); three decode steps over them; ``forward`` over 24 tokens."""
    cfg, V = net["cfg"], net["cfg"].vocab_size
    toks, fr = _inputs(cfg, seed=seed)
    jl, jc = net["jmodel"].prefill(net["jparams"],
                                   jnp.asarray(toks[:, :PROMPT]), MAX_LEN,
                                   extra=jnp.asarray(fr))
    tl, tc = net["model"].prefill(net["params"],
                                  torch.as_tensor(toks[:, :PROMPT]), MAX_LEN,
                                  extra=torch.as_tensor(fr))
    np.testing.assert_allclose(tl[..., :V].numpy(), _np(jl)[..., :V],
                               rtol=0, atol=ATOL)
    for i, layer in enumerate(tc["dec"]):
        assert layer["cross"]["k"].shape[1] == FRAMES
        for part in ("self", "cross"):
            for name in ("k", "v"):
                np.testing.assert_allclose(
                    layer[part][name].numpy(),
                    _np(jc["dec"][part][name][i]), rtol=0, atol=ATOL)
    for i in range(3):
        t = toks[:, PROMPT + i:PROMPT + i + 1]
        jl, jc = net["jmodel"].decode_step(net["jparams"], jc,
                                           jnp.asarray(t), PROMPT + i)
        tl, tc = net["model"].decode_step(net["params"], tc,
                                          torch.as_tensor(t), PROMPT + i)
        np.testing.assert_allclose(tl[..., :V].numpy(), _np(jl)[..., :V],
                                   rtol=0, atol=ATOL)
    jf, ja = net["jmodel"].forward(net["jparams"], jnp.asarray(toks),
                                   jnp.asarray(fr))
    tf, ta = net["model"].forward(net["params"], torch.as_tensor(toks),
                                  torch.as_tensor(fr))
    np.testing.assert_allclose(tf[..., :V].detach().numpy(),
                               _np(jf)[..., :V], rtol=0, atol=ATOL)
    assert float(ja) == 0.0 and ta == 0.0


def _bump_all(tree, seed=123):
    rng = np.random.default_rng(seed)

    def bump(a):
        a = np.asarray(a)
        if a.dtype != np.float32:
            return jnp.asarray(a)
        up = rng.random(a.shape) < 0.5
        return jnp.asarray(np.where(up, np.nextafter(a, np.float32(np.inf)),
                                    a))
    return jax.tree.map(bump, tree)


def test_last_bit_sensitivity():
    """At the reference's own init, one ulp on half the frames' entries
    moves the reference's own logits by more than 1e-2 (measured 0.059),
    and the port's gap there stays within SPREAD_FACTOR times the
    reference's spread under one ulp on every weight (measured 1.5e-2
    against 0.10)."""
    n = _setup(temper=False)
    cfg, V = n["cfg"], n["cfg"].vocab_size
    toks, _ = _inputs(cfg, seed=0)
    fr = np.random.default_rng(10).normal(
        size=(2, FRAMES, cfg.d_model)).astype(np.float32)
    a, _ = n["jmodel"].forward(n["jparams"], jnp.asarray(toks),
                               jnp.asarray(fr))
    up = np.random.default_rng(0).random(fr.shape) < 0.5
    fr2 = np.where(up, np.nextafter(fr, np.float32(np.inf)), fr)
    b, _ = n["jmodel"].forward(n["jparams"], jnp.asarray(toks),
                               jnp.asarray(fr2))
    assert float(jnp.abs(a - b)[..., :V].max()) > 1e-2
    c, _ = n["jmodel"].forward(_bump_all(n["jparams"]), jnp.asarray(toks),
                               jnp.asarray(fr))
    spread = float(jnp.abs(a - c)[..., :V].max())
    got, _ = n["model"].forward(n["params"], torch.as_tensor(toks),
                                torch.as_tensor(fr))
    gap = float(np.abs(got.detach().numpy() - _np(a))[..., :V].max())
    assert gap <= SPREAD_FACTOR * spread


def test_loss_and_grads_match(net):
    """``loss`` (with a mask) and every gradient leaf, frame projection,
    encoder and cross-attention included, against
    ``jax.value_and_grad``, remat per layer."""
    cfg = net["cfg"]
    toks, fr = _inputs(cfg, seed=3)
    mask = (np.arange(23)[None] < np.array([[23], [15]])).astype(np.float32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks),
          "frames": jnp.asarray(fr), "mask": jnp.asarray(mask)}
    tb = {k: torch.as_tensor(np.asarray(v)) for k, v in jb.items()}
    jl, jg = jax.jit(jax.value_and_grad(net["jmodel"].loss))(net["jparams"],
                                                             jb)
    tl, tg = train_loop.value_and_grad(net["model"].loss, net["params"], tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    jgt = encdec_params_from_numpy(cfg, jax.tree.map(np.asarray, jg), "cpu")
    for a, b in zip(leaves(tg), leaves(jgt)):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= GRAD_RTOL * max(
            float(b.abs().max()), 1e-6)


def test_policy_masks_match_reference(net):
    """``transformer_policy``'s masks on the per-layer ``enc_blocks/i`` and
    ``dec_blocks/i`` paths (``attn``, ``xattn``, ``mlp``) are the
    reference's stacked masks' layer slices."""
    jmasks = j_transformer_policy(0.75, 0.5).compile(
        net["jparams"]).masks(net["jparams"])
    masks = transformer_policy(0.75, 0.5).compile(
        net["params"]).masks(net["params"])
    seen = set()
    for path, m in masks.items():
        stack, i, leaf = path.split("/", 2)
        np.testing.assert_array_equal(
            m.numpy(), np.asarray(jmasks[f"{stack}/{leaf}"][int(i)]))
        seen.add(leaf.split("/")[0])
    assert len(masks) == sum(np.asarray(m).shape[0] for m in jmasks.values())
    assert seen == {"attn", "xattn", "mlp"}


def test_generate_matches_reference_engine(net):
    """``ServeEngine.generate(extra=frames)``, the reference's
    ``test_encdec_serves_through_engine`` setup (B=2, prompt 6, 16
    frames, max_len 20, 4 tokens), gives the reference engine's greedy
    tokens (every step's top-2 margin asserted above 10x ATOL); without
    frames the prefill raises, as the reference's does."""
    cfg = net["cfg"]
    prompt = np.asarray(jax.random.randint(jax.random.key(1), (2, 6), 0,
                                           cfg.vocab_size))
    frames = np.asarray(jax.random.normal(jax.random.key(2),
                                          (2, 16, cfg.d_model)))
    jeng = JEngine(net["jmodel"], net["jcfg"], max_len=20, batch=2)
    want = np.asarray(jeng.generate(net["jparams"], jnp.asarray(prompt), 4,
                                    extra=jnp.asarray(frames)))
    eng = ServeEngine(net["model"], max_len=20, device="cpu")
    got = eng.generate(net["params"], torch.as_tensor(prompt), 4,
                       extra=torch.as_tensor(frames))
    seq = torch.cat([torch.as_tensor(prompt), got.long()], 1)
    logits = net["model"].forward(net["params"], seq,
                                  torch.as_tensor(frames))[0][
        :, 5:-1, :cfg.vocab_size]
    top2 = logits.topk(2, -1).values
    assert float((top2[..., 0] - top2[..., 1]).min()) > 10 * ATOL
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="frames"):
        eng.generate(net["params"], torch.as_tensor(prompt), 4)


def test_scheduler_with_enc_len_frames_matches_b1(net):
    """Under ``ContinuousBatchingEngine`` (2 slots, 3 requests) with frames
    of the config's ``enc_len`` rows, each request's tokens equal its B=1
    ``generate``'s; frames of another length cannot join the slots'
    cross memory."""
    cfg = net["cfg"]
    g = np.random.default_rng(5)
    reqs = [(g.integers(0, cfg.vocab_size, (1, int(s))),
             g.normal(size=(1, cfg.enc_len, cfg.d_model)).astype(np.float32),
             int(b))
            for s, b in zip(g.integers(5, 12, 3), g.integers(3, 7, 3))]
    sched = ContinuousBatchingEngine(net["model"], net["params"], slots=2,
                                     max_len=MAX_LEN, chunk=4, device="cpu")
    uids = [sched.submit(p, b, extra=torch.as_tensor(f)) for p, f, b in reqs]
    res = sched.run()
    eng = ServeEngine(net["model"], max_len=MAX_LEN, device="cpu")
    for uid, (p, f, b) in zip(uids, reqs):
        want = eng.generate(net["params"], torch.from_numpy(p), b,
                            extra=torch.as_tensor(f))[0]
        np.testing.assert_array_equal(res[uid], want.numpy())
    sched.submit(reqs[0][0], 3, extra=torch.zeros(1, 16, cfg.d_model))
    with pytest.raises(ValueError, match="cannot join"):
        sched.run()


def test_int8_self_cache_decodes_near_bf16():
    """With ``kv_quant`` the decoder's self cache holds int8 codes and
    scales (the cross memory stays in the compute dtype, as the
    reference's prefill writes it): a decode step's logits within the
    reference's 0.08 relative gate of the unquantized cache's."""
    n, q = _setup(), _setup(kv_quant=True)
    toks, fr = _inputs(n["cfg"], seed=2)
    args = (torch.as_tensor(toks[:, :PROMPT]), MAX_LEN)
    extra = torch.as_tensor(fr)
    _, c = n["model"].prefill(n["params"], *args, extra=extra)
    _, cq = q["model"].prefill(n["params"], *args, extra=extra)
    assert cq["dec"][0]["self"]["k"].dtype == torch.int8
    assert cq["dec"][0]["cross"]["k"].dtype == torch.float32
    t = torch.as_tensor(toks[:, PROMPT:PROMPT + 1])
    lg, _ = n["model"].decode_step(n["params"], c, t, PROMPT)
    lq, _ = q["model"].decode_step(n["params"], cq, t, PROMPT)
    rel = float((lg - lq).abs().max() / lg.abs().max())
    assert 0 < rel < 0.08

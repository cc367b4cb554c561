"""The port's mixture-of-experts on the CPU against the JAX reference on
the same inputs: ``models/moe.py`` function by function (capacity, the
routing group, the iterative top-k with ties, ``moe_apply``'s expert ids,
ranks and drop set exactly, its output, load-balancing term and
gradients at a capacity that drops and one that does not), then
granite-moe-1b-a400m's and qwen3-moe-235b-a22b's smoke models
(``configs.smoke_config``: d 128, 8 experts, top-2) with the reference's
weights carried across by ``transformer_params_from_numpy``: prefill,
decode and ``forward`` logits and the aux loss, every gradient leaf,
``transformer_policy``'s masks on the ``moe/*`` leaves, greedy tokens
through ``ServeEngine``, the scheduler against B=1 and an LSTM draft's
speculative tokens against target-only. Routing decisions are compared
only where the routed probabilities' top-(k+1) margins exceed the
frameworks' gap on them (asserted: ``routing_margins``)."""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.models import LSTMConfig as JLSTMConfig, LSTMModel as JLSTMModel
from repro.models import build_model as j_build
from repro.models import layers as JL
from repro.models import moe as JM
from repro.serving import ServeEngine as JEngine
from repro.sparse import transformer_policy as j_transformer_policy
from repro_torch.configs import smoke_config
from repro_torch.models import (LSTMConfig, LSTMModel, build_model,
                                params_from_numpy,
                                transformer_params_from_numpy)
from repro_torch.models import moe as M
from repro_torch.serving import ServeEngine
from repro_torch.serving.runtime import leaves
from repro_torch.serving.scheduler import ContinuousBatchingEngine
from repro_torch.sparse import transformer_policy
from repro_torch.spec import DraftModel
from repro_torch.training import train_loop
from repro_torch.training.masked import brds_masks

FAMILIES = ("granite-moe-1b-a400m", "qwen3-moe-235b-a22b")
# float32 logits of the smoke models, the frameworks summing in other
# orders. granite (no qk-norm) amplifies a last-bit difference anywhere:
# one ulp on half the entries of every reference weight moves its own
# logits by 5.6e-5 to 1.2e-4 over four prompts (test_last_bit_
# sensitivity), and the port's gap is up to 3.7x that (measured 2.5e-4
# at one prompt, ≤ 6e-5 at the others). qwen3-moe normalizes q and k
# (measured gap ≤ 2.7e-6, spread ~2e-6). Each bound is at most 10x the
# measured gap.
ATOL = {"granite-moe-1b-a400m": 5e-4, "qwen3-moe-235b-a22b": 2e-5}
AUX_RTOL = 1e-6          # measured 1.2e-7
# every gradient leaf, relative to the leaf's largest entry
GRAD_RTOL = {"granite-moe-1b-a400m": 2e-3, "qwen3-moe-235b-a22b": 1e-4}
LOSS_RTOL = 2e-6
# the routed probabilities' top-(k+1) margins must exceed this where the
# frameworks' routing is compared (their probabilities differ by ≤ 1.2e-5
# in the smoke models' deepest layer)
MIN_MARGIN = 5e-5
# the same, at the function level, where both route the same x (their
# probabilities differ by < 1e-7)
FN_MIN_MARGIN = 1e-6
FN_RTOL = 1e-5           # moe_apply's output (measured 3.7e-7)
PROMPT, MAX_LEN = 21, 32


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
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@contextlib.contextmanager
def routing_margins():
    """Record the smallest gap between consecutive sorted probabilities
    among the top k+1 of every routing the port makes meanwhile."""
    seen = []
    real = M.topk_iterative

    def recording(probs, K):
        top = probs.sort(-1, descending=True).values[..., :K + 1]
        seen.append(float((top[..., :-1] - top[..., 1:]).min()))
        return real(probs, K)

    M.topk_iterative = recording
    try:
        yield seen
    finally:
        M.topk_iterative = real


# ------------------------------------------------------------- functions

@pytest.mark.parametrize("S,K,E,cf", [(24, 2, 8, 1.25), (1, 8, 32, 1.25),
                                      (512, 8, 32, 1.25), (512, 8, 128, 1.25),
                                      (48, 2, 8, 0.5), (7, 2, 8, 8.0)])
def test_capacity_matches(S, K, E, cf):
    assert M.capacity(S, K, E, cf) == JM.capacity(S, K, E, cf)


def test_routing_group():
    """min(moe_group, S), decremented until it divides S (the reference's
    loop in ``moe_apply``)."""
    assert [M.routing_group(S, g) for S, g in
            ((24, 1024), (2048, 1024), (21, 8), (1, 1024), (13, 4))] == \
        [24, 1024, 7, 1, 1]


def test_topk_iterative_ties_and_order():
    """Exact ties go to the lowest index and the slots keep the order of
    selection, as the reference's k argmax passes do."""
    probs = np.array([[0.1, 0.3, 0.3, 0.05, 0.25],
                      [0.2, 0.2, 0.2, 0.2, 0.2],
                      [0.0, 0.5, 0.1, 0.4, 0.0]], np.float32)
    jv, ji = JM._topk_iterative(jnp.asarray(probs), 3)
    ti = M.topk_iterative(torch.tensor(probs), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti[0].tolist() == [1, 2, 4] and ti[1].tolist() == [0, 1, 2]
    np.testing.assert_array_equal(
        torch.tensor(probs).gather(-1, ti).numpy(), np.asarray(jv))


def _moe_case(seed, E=8, K=2, d=64, ff=96, act="silu_glu", S=48):
    jp = JL.init_params(JM.moe_defs(d, ff, E, act, jnp.float32),
                        jax.random.key(seed))
    x = np.random.default_rng(seed).normal(size=(2, S, d)).astype(np.float32)
    return jp, _t(jp), x


def _reference_routing(jp, x, E, K, cf, G):
    """The reference's routing of ``x`` grouped by G: its router softmax,
    its ``_topk_iterative`` and its rank-within-expert lines (the cumsum
    of one-hots over the flattened (token, slot) pairs)."""
    xg = jnp.asarray(x).reshape(-1, G, x.shape[-1])
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", xg, jp["router"]), -1)
    _, ids = JM._topk_iterative(probs, K)
    onehot = jax.nn.one_hot(ids.reshape(xg.shape[0], G * K), E,
                            dtype=jnp.int32)
    rank = jnp.sum((jnp.cumsum(onehot, axis=1) - 1) * onehot, axis=-1)
    return np.asarray(probs), np.asarray(ids), np.asarray(rank)


@pytest.mark.parametrize("act", ["silu_glu", "gelu"])
@pytest.mark.parametrize("cf", [0.5, 8.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_moe_apply_matches(seed, cf, act):
    """Groups of 24 of 48 tokens, 8 experts, top-2: the expert ids, each
    pair's rank and the drop set (rank ≥ C) equal the reference's
    exactly, at a capacity factor that drops (0.5: C = 4) and one that
    does not (8.0); the output, with the dropped pairs' gates not
    renormalised, and the load-balancing term within tolerance."""
    E, K, G = 8, 2, 24
    jp, tp, x = _moe_case(seed, act=act)
    probs, jids, jrank = _reference_routing(jp, x, E, K, cf, G)
    top = np.sort(probs, -1)[..., ::-1][..., :K + 1]
    assert (top[..., :-1] - top[..., 1:]).min() > FN_MIN_MARGIN
    ids, gates, rank, C, aux = M.route(
        tp, torch.tensor(x).reshape(-1, G, x.shape[-1]), num_experts=E,
        top_k=K, capacity_factor=cf)
    assert C == JM.capacity(G, K, E, cf)
    np.testing.assert_array_equal(ids.numpy(), jids)
    np.testing.assert_array_equal(rank.numpy(), jrank)
    dropped = int((rank >= C).sum())
    assert (dropped > 0) == (cf < 1)
    kw = dict(num_experts=E, top_k=K, capacity_factor=cf, activation=act,
              group_size=G)
    jo, ja = JM.moe_apply(jp, jnp.asarray(x), **kw)
    to, ta = M.moe_apply(tp, torch.tensor(x), **kw)
    assert _rel(to, jo) < FN_RTOL
    assert abs(float(ta) - float(ja)) <= AUX_RTOL * abs(float(ja))


def test_moe_apply_gradients_match():
    """Gradients of sum(out · r) + aux with respect to x, the router and
    every expert weight, at a capacity that drops."""
    E, K, G, cf = 8, 2, 24, 0.5
    jp, tp, x = _moe_case(3)
    r = np.random.default_rng(9).normal(size=x.shape).astype(np.float32)
    kw = dict(num_experts=E, top_k=K, capacity_factor=cf,
              activation="silu_glu", group_size=G)

    def jloss(p, xx):
        o, a = JM.moe_apply(p, xx, **kw)
        return jnp.sum(o * r) + a

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    tpg = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    o, a = M.moe_apply(tpg, tx, **kw)
    ((o * torch.tensor(r)).sum() + a).backward()
    assert _rel(tx.grad, jgx) < 1e-5
    for k in tp:
        assert _rel(tpg[k].grad, jg[k]) < 1e-5, k


def test_moe_decode_step_is_graph_safe():
    """One token a sequence (a decode step): every group has one token,
    C = 4, nothing drops, and no op reads a size from the data (the same
    graph serves any routing)."""
    E, K = 8, 2
    jp, tp, x = _moe_case(4, S=1)
    kw = dict(num_experts=E, top_k=K, capacity_factor=1.25,
              activation="silu_glu", group_size=1024)
    jo, _ = JM.moe_apply(jp, jnp.asarray(x), **kw)
    to, _ = M.moe_apply(tp, torch.tensor(x), **kw)
    assert _rel(to, jo) < FN_RTOL


# ---------------------------------------------------------------- models

@functools.lru_cache(maxsize=None)
def _setup(arch, dtype="float32"):
    """The reference's model and seed-0 weights and the port's on them,
    made once a module (no test changes them)."""
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


def test_param_tree_and_dtypes(net):
    """The port's per-layer ``moe`` leaves are the reference's period
    slices; the param counts agree; a bf16 config keeps the router in
    float32."""
    model, params = net["model"], net["params"]
    assert model.param_count() == net["jmodel"].param_count()
    for i, layer in enumerate(params["layers"]):
        assert "mlp" not in layer
        assert sorted(layer["moe"]) == ["router", "w_down", "w_gate", "w_up"]
        for name, leaf in layer["moe"].items():
            np.testing.assert_array_equal(
                leaf.numpy(),
                np.asarray(net["jparams"]["blocks"][0]["moe"][name][i]))
    bf = _setup(net["cfg"].name, "bfloat16")["params"]["layers"][0]["moe"]
    assert bf["router"].dtype == torch.float32
    assert bf["w_up"].dtype == torch.bfloat16


def test_prefill_decode_and_forward_match(net):
    """A 21-token prompt (one routing group: C = 7, pairs dropped where
    the routing is uneven), three decode steps (one token a group: no
    drop) and ``forward`` over 24 tokens with its summed aux loss; every
    routing decision the port makes here has a top-(k+1) margin above
    MIN_MARGIN (asserted)."""
    cfg, atol = net["cfg"], ATOL[net["cfg"].name]
    V = cfg.vocab_size
    toks = _prompt(cfg, 2, 24, seed=2)
    jm = net["jmodel"]
    jprefill = jax.jit(jm.prefill, static_argnums=2)
    jdecode, jforward = jax.jit(jm.decode_step), jax.jit(jm.forward)
    with routing_margins() as margins:
        jl, jc = jprefill(net["jparams"], jnp.asarray(toks[:, :PROMPT]),
                          MAX_LEN)
        tl, tc = net["model"].prefill(net["params"],
                                      torch.as_tensor(toks[:, :PROMPT]),
                                      MAX_LEN)
        np.testing.assert_allclose(tl[..., :V].numpy(), _np(jl)[..., :V],
                                   rtol=0, atol=atol)
        for i in range(3):
            t = toks[:, PROMPT + i:PROMPT + i + 1]
            jl, jc = jdecode(net["jparams"], jc, jnp.asarray(t), PROMPT + i)
            tl, tc = net["model"].decode_step(net["params"], tc,
                                              torch.as_tensor(t), PROMPT + i)
            np.testing.assert_allclose(tl[..., :V].numpy(),
                                       _np(jl)[..., :V], rtol=0, atol=atol)
        jf, ja = jforward(net["jparams"], jnp.asarray(toks))
        tf, ta = net["model"].forward(net["params"], torch.as_tensor(toks))
    assert min(margins) > MIN_MARGIN
    np.testing.assert_allclose(tf[..., :V].numpy(), _np(jf)[..., :V],
                               rtol=0, atol=atol)
    assert abs(float(ta) - float(ja)) <= AUX_RTOL * abs(float(ja))


def test_last_bit_sensitivity():
    """Why granite is held to 5e-4: moving the last bit of half the
    entries of every reference weight moves the reference's own logits by
    more than 5e-5 (measured 5.6e-5 to 1.2e-4 over four prompts)."""
    n = _setup("granite-moe-1b-a400m")
    rng = np.random.default_rng(123)

    def bump(a):
        a = np.asarray(a)
        if a.dtype != np.float32:
            return jnp.asarray(a)
        up = rng.random(a.shape) < 0.5
        return jnp.asarray(np.where(up, np.nextafter(a, np.float32(np.inf)),
                                    a))

    moved = jax.tree.map(bump, n["jparams"])
    toks = jnp.asarray(_prompt(n["cfg"], 2, 24, seed=1))
    V = n["cfg"].vocab_size
    a, _ = n["jmodel"].forward(n["jparams"], toks)
    b, _ = n["jmodel"].forward(moved, toks)
    assert float(jnp.abs(a - b)[..., :V].max()) > 5e-5


def test_loss_and_grads_match(net):
    """``loss`` (cross-entropy plus aux_loss_coef times the summed
    load-balancing terms, with a mask) and every gradient leaf, router
    included, against ``jax.value_and_grad``, remat per layer."""
    cfg = net["cfg"]
    toks = _prompt(cfg, 2, 24, seed=1)
    mask = (np.arange(23)[None] < np.array([[23], [15]])).astype(np.float32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks),
          "mask": jnp.asarray(mask)}
    tb = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(toks),
          "mask": torch.as_tensor(mask)}
    jl, jg = jax.jit(jax.value_and_grad(net["jmodel"].loss))(net["jparams"],
                                                             jb)
    with routing_margins() as margins:
        tl, tg = train_loop.value_and_grad(net["model"].loss, net["params"],
                                           tb)
    assert min(margins) > MIN_MARGIN
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    jgt = transformer_params_from_numpy(cfg, jax.tree.map(np.asarray, jg),
                                        "cpu")
    tol = GRAD_RTOL[cfg.name]
    for a, b in zip(leaves(tg), leaves(jgt)):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= tol * max(
            float(b.abs().max()), 1e-6)


def test_policy_masks_match_reference(net):
    """``transformer_policy``'s masks on the port's per-layer ``moe/w_*``
    (an (E, d, ff) weight under ``in_out`` is d_in = E·d, as the
    reference's stacked core) and ``attn/w*`` leaves are the per-period
    slices of the reference's; the router is not pruned; the deprecated
    ``brds_masks`` gives the same."""
    jmasks = j_transformer_policy(0.75, 0.5).compile(
        net["jparams"]).masks(net["jparams"])
    masks = transformer_policy(0.75, 0.5).compile(
        net["params"]).masks(net["params"])
    seen = set()
    for path, m in masks.items():
        _, i, leaf = path.split("/", 2)
        jm = jmasks[f"blocks/0/{leaf}"][int(i)]
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
        seen.add(leaf)
    assert len(masks) == sum(np.asarray(m).shape[0] for m in jmasks.values())
    assert {"moe/w_gate", "moe/w_up", "moe/w_down", "attn/wq"} <= seen
    assert not any("router" in p for p in masks)
    with pytest.warns(DeprecationWarning):
        shim = brds_masks(net["params"], 0.75, 0.5)
    assert shim.keys() == masks.keys()
    assert all(torch.equal(shim[k], masks[k]) for k in masks)


# greedy parity at prompt seeds whose every step's top-2 margin is at
# least 10x the logits' bound (asserted)
GREEDY_SEED = {"granite-moe-1b-a400m": 0, "qwen3-moe-235b-a22b": 0}


def test_greedy_generate_matches(net):
    """``ServeEngine.generate`` gives the reference engine's greedy
    tokens."""
    cfg = net["cfg"]
    prompt = _prompt(cfg, 2, PROMPT, GREEDY_SEED[cfg.name])
    jeng = JEngine(net["jmodel"], net["jcfg"], max_len=MAX_LEN, batch=2)
    want = np.asarray(jeng.generate(net["jparams"], jnp.asarray(prompt), 8))
    eng = ServeEngine(net["model"], max_len=MAX_LEN, device="cpu")
    got = eng.generate(net["params"], torch.as_tensor(prompt), 8)
    seq = torch.cat([torch.as_tensor(prompt), got.long()], 1)
    logits = net["model"].forward(net["params"], seq)[0][
        :, PROMPT - 1:-1, :cfg.vocab_size]
    top2 = logits.topk(2, -1).values
    assert float((top2[..., 0] - top2[..., 1]).min()) > 10 * ATOL[cfg.name]
    np.testing.assert_array_equal(got.numpy(), want)


def test_scheduler_matches_b1():
    """granite under ``ContinuousBatchingEngine`` (2 slots, 4 requests,
    exact-length prefill): each request's tokens equal its lockstep B=1
    greedy tokens (a decode step routes each token in a group of its own,
    so slots do not share capacity)."""
    n = _setup("granite-moe-1b-a400m")
    g = np.random.default_rng(4)
    reqs = [(g.integers(0, 512, (1, int(s))), int(b))
            for s, b in zip(g.integers(6, 20, 4), g.integers(4, 9, 4))]
    sched = ContinuousBatchingEngine(n["model"], n["params"], slots=2,
                                     max_len=MAX_LEN, chunk=4, device="cpu")
    uids = [sched.submit(p, b) for p, b in reqs]
    res = sched.run()
    eng = ServeEngine(n["model"], max_len=MAX_LEN, device="cpu")
    for uid, (p, b) in zip(uids, reqs):
        want = eng.generate(n["params"], torch.from_numpy(p), b)[0]
        np.testing.assert_array_equal(res[uid], want.numpy())


def test_spec_with_lstm_draft_lossless():
    """granite as the target of an LSTM draft (k=3): the target-only
    greedy tokens, and the reference engine's."""
    n = _setup("granite-moe-1b-a400m")
    kw = dict(input_size=16, hidden=32, num_layers=1, vocab_size=512)
    jd = JLSTMModel(JLSTMConfig("d", **kw))
    draft = DraftModel(LSTMModel(LSTMConfig("d", **kw)), params_from_numpy(
        jax.tree.map(np.asarray, jd.init(jax.random.key(1))), "cpu"))
    prompt = _prompt(n["cfg"], 2, PROMPT, GREEDY_SEED[n["cfg"].name])
    eng = ServeEngine(n["model"], max_len=MAX_LEN, device="cpu")
    base = eng.generate(n["params"], torch.as_tensor(prompt), 8)
    spec, st = eng.generate(n["params"], torch.as_tensor(prompt), 8,
                            draft=draft, spec_k=3, return_state=True)
    assert torch.equal(base, spec) and int(st["rounds"].min()) >= 1
    jeng = JEngine(n["jmodel"], n["jcfg"], max_len=MAX_LEN, batch=2)
    want = np.asarray(jeng.generate(n["jparams"], jnp.asarray(prompt), 8))
    np.testing.assert_array_equal(spec.numpy(), want)

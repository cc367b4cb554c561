"""The captured decode loop and the captured spec chunk, on the CPU.

``runtime.decode_body`` (the step a CUDA graph captures) run eagerly over
its static buffers must be bitwise the host loop it replaced
(``decode_loop_eager``) on tokens, cache, logits, pos, done and emitted,
for the LSTM's packed float, temporal-delta, q8 and delta + q8 paths,
fused and chained, dense, and the transformer; its greedy tokens equal
the JAX reference's ``decode_loop`` at seeds whose argmax margins are
checked. ``spec.spec_round`` with every row inactive changes nothing, so
chunks of 1, 3 or 8 rounds give one result, and greedy speculative tokens
equal JAX ``spec_decode_loop``'s. ``CountedGraph``'s launch bookkeeping
runs on a fake graph. The card tests skip without a card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.models import LSTMConfig as JConfig, LSTMModel as JModel
from repro.models import build_model as j_build
from repro.serving import SamplingConfig as JSampling
from repro.serving import decode_loop as j_decode_loop
from repro.serving import sample_dist as j_sample_dist
from repro.spec import DraftModel as JDraft
from repro.spec import spec_decode_loop as j_spec_decode_loop
from repro.sparse import lstm_policy as jlstm_policy
from repro.sparse import use_backend as j_use_backend
from repro_torch.configs import smoke_config
from repro_torch.kernels import _build
from repro_torch.models import (LSTMConfig, LSTMModel, build_model,
                                params_from_numpy,
                                transformer_params_from_numpy)
from repro_torch.serving import SamplingConfig, ServeEngine, sample_dist
from repro_torch.serving import runtime
from repro_torch.sparse import DeltaGateConfig, QuantConfig, lstm_policy
from repro_torch.spec import DraftModel, spec_decode_loop, spec_round
from repro_torch.spec import verify as V

MAX_LEN = 40
GREEDY = SamplingConfig()
MARGIN = 1e-4     # greedy parity with JAX holds above this top-2 margin
needs_card = pytest.mark.skipif(not torch.cuda.is_available(),
                                reason="needs a CUDA card: CUDA graphs "
                                       "capture and replay only there")

# every LSTM serving path: (fused, policy rules); None = dense
LSTM_PATHS = {
    "dense": None,
    "float_fused": (True, {}),
    "float_chained": (False, {}),
    "delta0_fused": (True, {"delta": DeltaGateConfig()}),
    "delta0_chained": (False, {"delta": DeltaGateConfig()}),
    "delta005_fused": (True, {"delta": DeltaGateConfig(0.05, 0.05)}),
    "int8_fused": (True, {"quant": QuantConfig("int8")}),
    "int8_chained": (False, {"quant": QuantConfig("int8")}),
    "q1.11_fused": (True, {"quant": QuantConfig("q1.11")}),
    "delta0_int8_fused": (True, {"delta": DeltaGateConfig(),
                                 "quant": QuantConfig("int8")}),
    "delta0_int8_chained": (False, {"delta": DeltaGateConfig(),
                                    "quant": QuantConfig("int8")}),
}


@pytest.fixture(scope="module")
def lstm():
    kw = dict(input_size=16, hidden=32, num_layers=2, vocab_size=50)
    jmodel = JModel(JConfig("t", **kw))
    jparams = jmodel.init(jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    prompt = np.asarray(jax.random.randint(jax.random.key(1), (3, 7), 0, 50))
    return dict(jmodel=jmodel, jparams=jparams, params=params,
                model=LSTMModel(LSTMConfig("t", **kw)), prompt=prompt,
                calib=torch.from_numpy(
                    np.random.default_rng(9).integers(0, 50, (2, 8))),
                paths={})


@pytest.fixture(scope="module")
def qwen():
    jcfg, cfg = j_smoke("qwen3-0.6b"), smoke_config("qwen3-0.6b")
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    params = transformer_params_from_numpy(
        cfg, jax.tree.map(np.asarray, jparams), "cpu")
    return dict(jmodel=jmodel, jparams=jparams, model=build_model(cfg),
                params=params, cfg=cfg)


def _path(lstm, name):
    """(model, params) of one LSTM serving path, prepared on the CPU."""
    if name not in lstm["paths"]:
        spec = LSTM_PATHS[name]
        if spec is None:
            lstm["paths"][name] = (lstm["model"], lstm["params"])
        else:
            fused, rules = spec
            eng = ServeEngine(lstm["model"].with_fused(fused),
                              max_len=MAX_LEN, device="cpu",
                              sparsity=lstm_policy(0.75, 0.5, **rules))
            packed, _ = eng.prepare(lstm["params"], calib=lstm["calib"]
                                    if "quant" in rules else None)
            lstm["paths"][name] = (eng.model, packed)
    return lstm["paths"][name]


def _same_tree(a, b):
    la, lb = runtime.leaves(a), runtime.leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _both_loops(model, params, prompt, steps, sampling, *, ragged,
                device="cpu"):
    """(decode_loop, decode_loop_eager) results from the same prefill,
    lockstep (scalar position) or ragged (per-row positions, a budget, a
    row that starts done)."""
    tokens = torch.as_tensor(prompt, device=device)
    B = tokens.shape[0]
    kw = dict(limit=MAX_LEN)
    if ragged:
        lengths = torch.tensor([tokens.shape[1], 4, 2][:B], device=device)
        logits, cache = model.prefill(params, tokens, MAX_LEN,
                                      length=lengths)
        pos = lengths
        kw.update(budget=torch.tensor([3, 9, 5][:B], device=device),
                  done=torch.tensor([False, False, True][:B],
                                    device=device))
    else:
        logits, cache = model.prefill(params, tokens, MAX_LEN)
        pos = tokens.shape[1]
    out = []
    for fn in (runtime.decode_loop, runtime.decode_loop_eager):
        c = runtime.unflatten(cache, [x.clone()
                                      for x in runtime.leaves(cache)])
        out.append(fn(model, params, c, logits, pos, None, steps, sampling,
                      **kw))
    return out


# ------------------------------------------------------------ decode body

@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("name", list(LSTM_PATHS))
def test_body_bitwise_host_loop_lstm(lstm, name, ragged):
    model, params = _path(lstm, name)
    (t1, s1), (t2, s2) = _both_loops(model, params, lstm["prompt"], 9,
                                     GREEDY, ragged=ragged)
    assert torch.equal(t1, t2) and t1.dtype == torch.int32
    for key in ("cache", "logits", "pos", "done", "emitted"):
        assert _same_tree(s1[key], s2[key]), key


@pytest.mark.parametrize("per_row", [False, True])
def test_body_bitwise_host_loop_transformer(qwen, per_row):
    """Lockstep, and per-row positions (the KV cache written by a per-row
    scatter) with a budget and a row that starts done."""
    m, p = qwen["model"], qwen["params"]
    prompt = np.random.default_rng(6).integers(0, qwen["cfg"].vocab_size,
                                               (2, 6))
    logits, cache = m.prefill(p, torch.as_tensor(prompt), MAX_LEN)
    pos, kw = 6, dict(limit=MAX_LEN)
    if per_row:
        pos = torch.full((2,), 6)
        kw.update(budget=torch.tensor([3, 9]),
                  done=torch.tensor([False, True]))
    out = []
    for fn in (runtime.decode_loop, runtime.decode_loop_eager):
        c = runtime.unflatten(cache, [x.clone()
                                      for x in runtime.leaves(cache)])
        out.append(fn(m, p, c, logits, pos, None, 7, GREEDY, **kw))
    (t1, s1), (t2, s2) = out
    assert torch.equal(t1, t2)
    for key in ("cache", "logits", "pos", "done", "emitted"):
        assert _same_tree(s1[key], s2[key]), key


def test_body_eos_and_temperature_draw_as_the_host_loop(lstm):
    """An EOS stop mid-stream, and temperature sampling from a seeded
    generator: the same tokens, and the generator advanced alike."""
    model, params = _path(lstm, "float_fused")
    free, _ = _both_loops(model, params, lstm["prompt"], 8, GREEDY,
                          ragged=False)[1]
    eos = SamplingConfig(eos_id=int(free[0, 2]))
    (t1, s1), (t2, s2) = _both_loops(model, params, lstm["prompt"], 8, eos,
                                     ragged=False)
    assert torch.equal(t1, t2) and bool(s1["done"][0])
    assert (t1[0, 3:] == eos.pad_id).all()
    samp = SamplingConfig(temperature=0.9, top_k=8)
    tokens = torch.as_tensor(lstm["prompt"])
    logits, cache = model.prefill(params, tokens, MAX_LEN)
    got = []
    for fn in (runtime.decode_loop, runtime.decode_loop_eager):
        g = torch.Generator().manual_seed(4)
        toks, _ = fn(model, params, cache, logits, tokens.shape[1], g, 8,
                     samp, limit=MAX_LEN)
        got.append((toks, g.get_state()))
    assert torch.equal(got[0][0], got[1][0])
    assert torch.equal(got[0][1], got[1][1])


def test_decode_loop_leaves_the_callers_tensors(lstm):
    """The loop works on its own carry: the caller's cache and logits are
    as they were, and a zero-step call returns them."""
    model, params = _path(lstm, "float_fused")
    tokens = torch.as_tensor(lstm["prompt"])
    logits, cache = model.prefill(params, tokens, MAX_LEN)
    before = [x.clone() for x in runtime.leaves((cache, logits))]
    runtime.decode_loop(model, params, cache, logits, 7, None, 5, GREEDY)
    assert all(torch.equal(a, b) for a, b in
               zip(before, runtime.leaves((cache, logits))))
    toks, st = runtime.decode_loop(model, params, cache, logits, 7, None,
                                   0, GREEDY)
    assert toks.shape == (3, 0) and int(st["pos"]) == 7


def _margin_ok(model, params, prompt, toks):
    """Smallest top-2 margin of the teacher-forced logits of the generated
    tokens is above MARGIN."""
    seq = torch.cat([torch.as_tensor(prompt), toks.long()], 1)
    logits, cache = model.prefill(params, seq[:, :prompt.shape[1]], MAX_LEN)
    rows = [logits[:, 0]]
    for t in range(toks.shape[1] - 1):
        logits, cache = model.decode_step(params, cache, toks[:, t:t + 1],
                                          prompt.shape[1] + t)
        rows.append(logits[:, 0])
    top2 = torch.stack(rows, 1).topk(2, dim=-1).values
    return float((top2[..., 0] - top2[..., 1]).min()) > MARGIN


def test_greedy_matches_jax_decode_loop_lstm(lstm):
    """Packed float: the port's captured body, JAX's scan, same tokens."""
    plan = jlstm_policy(0.75, 0.5, backend="ref").compile(lstm["jparams"])
    jpacked, _ = plan.pack(*plan.prune(lstm["jparams"]))
    model, packed = _path(lstm, "float_fused")
    prompt, steps = lstm["prompt"], 10
    with j_use_backend("ref"):
        jl, jc = lstm["jmodel"].prefill(jpacked, jnp.asarray(prompt),
                                        MAX_LEN)
        jt, js = j_decode_loop(lstm["jmodel"], jpacked, jc, jl,
                               jnp.int32(prompt.shape[1]), jax.random.key(0),
                               steps, JSampling(), limit=MAX_LEN)
    logits, cache = model.prefill(packed, torch.as_tensor(prompt), MAX_LEN)
    toks, st = runtime.decode_loop(model, packed, cache, logits,
                                   prompt.shape[1], None, steps, GREEDY,
                                   limit=MAX_LEN)
    assert _margin_ok(model, packed, prompt, toks)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jt))
    for k in ("pos", "done", "emitted"):
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(js[k]))


def test_greedy_matches_jax_decode_loop_transformer(qwen):
    prompt = np.random.default_rng(6).integers(0, qwen["cfg"].vocab_size,
                                               (2, 6))
    jl, jc = qwen["jmodel"].prefill(qwen["jparams"], jnp.asarray(prompt),
                                    MAX_LEN)
    jt, _ = j_decode_loop(qwen["jmodel"], qwen["jparams"], jc, jl,
                          jnp.int32(6), jax.random.key(0), 6, JSampling(),
                          limit=MAX_LEN)
    m, p = qwen["model"], qwen["params"]
    logits, cache = m.prefill(p, torch.as_tensor(prompt), MAX_LEN)
    toks, _ = runtime.decode_loop(m, p, cache, logits, 6, None, 6, GREEDY,
                                  limit=MAX_LEN)
    assert _margin_ok(m, p, prompt, toks)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jt))


# ------------------------------------------------------- the static cache

def test_prefill_builds_in_a_given_cache(qwen):
    """The transformer's ``prefill(cache=)`` builds in the cache it is
    given, whatever it held, exactly as in a new one: logits and every
    leaf equal, the given leaves returned."""
    m, p = qwen["model"], qwen["params"]
    tokens = torch.as_tensor(np.random.default_rng(6).integers(
        0, qwen["cfg"].vocab_size, (2, 6)))
    logits, cache = m.prefill(p, tokens, MAX_LEN)
    given = runtime.unflatten(cache, [torch.full_like(x, 7.0) for x in
                                      runtime.leaves(cache)])
    held = runtime.leaves(given)
    logits2, cache2 = m.prefill(p, tokens, MAX_LEN, cache=given)
    assert torch.equal(logits, logits2) and _same_tree(cache, cache2)
    assert all(a is b for a, b in zip(runtime.leaves(cache2), held))
    assert runtime.prefill_accepts_cache(m)
    assert not runtime.prefill_accepts_cache(LSTMModel(LSTMConfig(
        "t", 16, 32, vocab_size=50)))


def test_dropped_trees_free_their_tensors_at_once():
    """A tree built by ``unflatten`` (``clone_tree``, the static carry, a
    capture's warm-up copy) holds no reference cycle: dropped, its
    tensors go at once, with the garbage collector off."""
    import gc
    import weakref
    gc.disable()
    try:
        tree = runtime.clone_tree({"layers": [{"k": torch.ones(3),
                                               "v": torch.zeros(2)}],
                                   "pos": [torch.ones(1)]})
        refs = [weakref.ref(x) for x in runtime.leaves(tree)]
        del tree
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


def test_static_cache_is_the_loops_cache(qwen):
    """``GraphCache.static_cache`` gives the buffers ``static_carry``
    hands every loop as its ``cache``, so a prefill built there is not
    copied again; other roles get buffers of their own."""
    m = qwen["model"]
    graphs = runtime.GraphCache()
    static = graphs.static_cache(m, 2, MAX_LEN, "cpu")
    like = m.init_cache(2, MAX_LEN, "cpu")
    for role in ("decode", "spec"):
        carry = graphs.static_carry(role, {"cache": like,
                                           "pos": torch.zeros(2)})
        assert all(a is b for a, b in zip(runtime.leaves(carry["cache"]),
                                          runtime.leaves(static)))
    assert graphs.static_carry("decode", {"pos": torch.zeros(2)})["pos"] \
        is not graphs.static_carry("spec", {"pos": torch.zeros(2)})["pos"]
    other = graphs.static_cache(m, 3, MAX_LEN, "cpu")
    assert runtime.leaves(other)[0].shape[0] == 3


def test_engine_prefills_into_its_static_cache(qwen, monkeypatch):
    """``ServeEngine.generate`` hands a model whose prefill takes
    ``cache`` its graphs' static cache (the one its captured loops
    decode in) and gets the same tokens as a new cache gives."""
    m, p = qwen["model"], qwen["params"]
    eng = ServeEngine(m, max_len=MAX_LEN, device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(6).integers(
        0, qwen["cfg"].vocab_size, (2, 6)))
    static = eng.graphs.static_cache(m, 2, MAX_LEN, "cpu")
    given = []
    real = m.prefill

    def prefill(params, tokens, max_len, extra=None, cache=None):
        given.append(cache)
        return real(params, tokens, max_len, extra=extra, cache=cache)

    monkeypatch.setattr(m, "prefill", prefill)
    toks = eng.generate(p, tokens, 5)
    assert given[0] is not None and all(
        a is b for a, b in zip(runtime.leaves(given[0]),
                               runtime.leaves(static)))
    logits, cache = real(p, tokens, MAX_LEN)
    want, _ = runtime.decode_loop_eager(m, p, cache, logits, 6, None, 5,
                                        GREEDY, limit=MAX_LEN)
    assert torch.equal(toks, want)


# -------------------------------------------------------- launch counting

class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


class _FakeCapture:
    """Stands in for ``torch.cuda.graph``: the body runs once, eagerly."""

    def __init__(self, graph):
        self.graph = graph

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_counted_graph_replays_its_captured_launches(monkeypatch):
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.LAUNCHES,
                                                          0))

    def body():     # what the kernel wrappers do while being captured
        _build.LAUNCHES["fused_brds_lstm_step"] += 2
        _build.LAUNCHES["decode_attention"] += 1

    g = runtime.CountedGraph(_FakeGraph(), capture_ctx=_FakeCapture)
    g.capture(body)
    assert not any(_build.LAUNCHES.values())    # a capture launches nothing
    assert g.launches == {"fused_brds_lstm_step": 2, "decode_attention": 1}
    for n in (1, 2, 3):
        g.replay()
        assert g.graph.replays == n
        assert _build.LAUNCHES["fused_brds_lstm_step"] == 2 * n
        assert _build.LAUNCHES["decode_attention"] == n
        assert sum(_build.LAUNCHES.values()) == 3 * n


def test_counted_graph_failed_capture_raises_and_counts_nothing(
        monkeypatch):
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.LAUNCHES,
                                                          5))

    def body():
        _build.LAUNCHES["lstm_gates"] += 1
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    g = runtime.CountedGraph(_FakeGraph(), capture_ctx=_FakeCapture)
    with pytest.raises(RuntimeError, match="capturing"):
        g.capture(body)
    assert set(_build.LAUNCHES.values()) == {5}


def test_counted_graph_captures_with_collection_off():
    """No garbage collection during a capture (a collected graph's
    teardown would invalidate it), and the collector's state restored
    after, on success and on failure."""
    import gc
    seen = []

    def body():
        seen.append(gc.isenabled())

    assert gc.isenabled()
    runtime.CountedGraph(_FakeGraph(), capture_ctx=_FakeCapture).capture(
        body)
    assert seen == [False] and gc.isenabled()
    with pytest.raises(ZeroDivisionError):
        runtime.CountedGraph(_FakeGraph(), capture_ctx=_FakeCapture
                             ).capture(lambda: 1 / 0)
    assert gc.isenabled()
    gc.disable()
    try:
        runtime.CountedGraph(_FakeGraph(), capture_ctx=_FakeCapture
                             ).capture(body)
        assert not gc.isenabled()
    finally:
        gc.enable()


def test_captured_loop_runs_eagerly_on_the_cpu():
    carry = {"x": torch.zeros(3)}
    loop = runtime.CapturedLoop(lambda c: c["x"].add_(1.0), carry)
    for _ in range(3):
        loop.run()
    assert loop.graph is None and carry["x"].tolist() == [3.0] * 3


# ------------------------------------------------------------- spec chunk

def _spec_inputs(lstm, model, params, draft, prompt):
    tokens = torch.as_tensor(prompt)
    logits, cache = model.prefill(params, tokens, MAX_LEN)
    _, dstate = draft.prefill(draft.params, tokens, MAX_LEN)
    return cache, dstate, sample_dist(logits[:, -1], GREEDY), \
        tokens.shape[1]


def _packed_draft(lstm):
    return DraftModel(*_path(lstm, "float_chained"))


@pytest.mark.parametrize("target", ["lstm", "transformer"])
def test_inactive_round_changes_nothing(lstm, qwen, target):
    """A round with every row done or at ``steps`` leaves every buffer of
    the carry (tokens, both caches, probs, pos, counters) as it was."""
    if target == "lstm":
        model, params = _path(lstm, "float_fused")
        prompt = lstm["prompt"]
        draft = _packed_draft(lstm)
    else:
        model, params = qwen["model"], qwen["params"]
        prompt = np.random.default_rng(6).integers(0, 50, (3, 6))
        dcfg = LSTMConfig("d", 16, 32, num_layers=1,
                          vocab_size=qwen["model"].vocab_padded)
        dm = LSTMModel(dcfg)
        draft = DraftModel(dm, dm.init(torch.Generator().manual_seed(7),
                                       "cpu"))
    cache, dstate, probs, P = _spec_inputs(lstm, model, params, draft,
                                           prompt)
    B, steps = prompt.shape[0], 6
    z = torch.zeros(B, dtype=torch.int32)
    carry = dict(cache=cache, dstate=dstate, probs=probs,
                 pos=torch.full((B,), P, dtype=torch.int32),
                 done=torch.tensor([True, False, True]),
                 emitted=torch.tensor([2, steps, 0], dtype=torch.int32),
                 rounds=z + 1, drafted=z + 4, accepted=z + 2,
                 tokens=torch.arange(B * steps, dtype=torch.int32
                                     ).reshape(B, steps))
    before = [x.clone() for x in runtime.leaves(carry)]
    for _ in range(2):
        spec_round(model, draft, params, draft.params, carry, 4, None,
                   GREEDY, V.cache_leaf_flags(model), steps=steps,
                   limit=MAX_LEN)
    after = runtime.leaves(carry)
    assert all(torch.equal(a, b) for a, b in zip(before, after))


@pytest.mark.parametrize("rounds", [1, 3, 8])
def test_spec_chunk_result_independent_of_rounds(lstm, rounds):
    """A budget, a row done from the start and an EOS: every chunk size
    gives the R = 4 result, tokens and state, and the reference's."""
    model, params = _path(lstm, "float_fused")
    draft = _packed_draft(lstm)
    prompt = lstm["prompt"]
    free = ServeEngine(model, max_len=MAX_LEN, device="cpu").generate(
        params, torch.as_tensor(prompt), 10)
    samp = SamplingConfig(eos_id=int(free[2, 4]))
    kw = dict(done=torch.tensor([False, True, False]),
              budget=torch.tensor([4, 9, 9]), limit=MAX_LEN)
    res = []
    for r in (4, rounds):
        cache, dstate, probs, P = _spec_inputs(lstm, model, params, draft,
                                               prompt)
        res.append(spec_decode_loop(model, draft, params, draft.params,
                                    cache, dstate, probs, P, None, 10, 3,
                                    samp, rounds_per_chunk=r, **kw))
    (t1, s1), (t2, s2) = res
    assert torch.equal(t1, t2)
    for key in ("cache", "dstate", "probs", "pos", "done", "emitted",
                "rounds", "drafted", "accepted"):
        assert _same_tree(s1[key], s2[key]), key
    assert s2["chunks"] == -(-int(s1["rounds"].max()) // rounds)
    assert (t1[1] == samp.pad_id).all() and int(s1["emitted"][0]) == 4


@pytest.mark.parametrize("rounds", [1, 3, 8])
def test_engine_spec_rounds(lstm, rounds):
    """``ServeEngine(spec_rounds=R)`` runs chunks of R rounds: the tokens
    and state of the default engine (R = ``ROUNDS_PER_CHUNK``), in
    ceil(rounds / R) chunks."""
    from repro_torch.spec import ROUNDS_PER_CHUNK
    model, params = _path(lstm, "float_fused")
    draft = _packed_draft(lstm)
    prompt = torch.as_tensor(lstm["prompt"])
    res = {}
    for r in (None, rounds):
        eng = ServeEngine(model, max_len=MAX_LEN, device="cpu",
                          spec_rounds=r)
        assert eng.spec_rounds == (ROUNDS_PER_CHUNK if r is None else r)
        res[r] = eng.generate(params, prompt, 10, draft=draft, spec_k=3,
                              return_state=True)
    (t1, s1), (t2, s2) = res[None], res[rounds]
    assert torch.equal(t1, t2)
    for key in ("cache", "dstate", "pos", "rounds", "accepted"):
        assert _same_tree(s1[key], s2[key]), key
    assert s2["chunks"] == -(-int(s1["rounds"].max()) // rounds)


@pytest.mark.parametrize("k", [1, 4])
def test_spec_greedy_matches_jax(lstm, k):
    """Greedy spec tokens and round counters equal JAX
    ``spec_decode_loop``'s (packed draft on the dense target)."""
    jm, jp, m, p = (lstm[key] for key in ("jmodel", "jparams", "model",
                                          "params"))
    plan = jlstm_policy(0.75, 0.5, backend="ref").compile(jp)
    jd = JDraft(jm, plan.pack(*plan.prune(jp))[0])
    d = DraftModel(*_path(lstm, "float_fused"))
    prompt, steps = lstm["prompt"], 9
    with j_use_backend("ref"):
        jl, jc = jm.prefill(jp, jnp.asarray(prompt), MAX_LEN)
        _, jds = jd.prefill(jd.params, jnp.asarray(prompt), MAX_LEN)
        jt, jst = j_spec_decode_loop(
            jm, jd, jp, jd.params, jc, jds, j_sample_dist(jl[:, -1],
                                                          JSampling()),
            prompt.shape[1], jax.random.key(0), steps, k, JSampling(),
            limit=MAX_LEN)
    cache, dstate, probs, P = _spec_inputs(lstm, m, p, d, prompt)
    toks, st = spec_decode_loop(m, d, p, d.params, cache, dstate, probs, P,
                                None, steps, k, GREEDY, limit=MAX_LEN)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jt))
    for key in ("rounds", "drafted", "accepted", "emitted", "pos"):
        np.testing.assert_array_equal(st[key].numpy(), np.asarray(jst[key]),
                                      err_msg=key)
    base = ServeEngine(m, max_len=MAX_LEN, device="cpu").generate(
        p, torch.as_tensor(prompt), steps)
    assert torch.equal(toks, base)


# ---------------------------------------------------------------- on card

@needs_card
@pytest.mark.parametrize("name", ["float_fused", "float_chained",
                                  "delta0_fused", "int8_chained"])
def test_captured_loop_bitwise_eager_on_card(lstm, name):
    """On the card the loop is a replayed CUDA graph: bitwise the host
    loop, lockstep and ragged."""
    fused, rules = LSTM_PATHS[name]
    eng = ServeEngine(lstm["model"].with_fused(fused), max_len=MAX_LEN,
                      device="cuda", sparsity=lstm_policy(0.75, 0.5,
                                                          **rules))
    params = params_from_numpy(jax.tree.map(np.asarray, lstm["jparams"]),
                               "cuda")
    packed, _ = eng.prepare(params, calib=lstm["calib"].cuda()
                            if "quant" in rules else None)
    for ragged in (False, True):
        (t1, s1), (t2, s2) = _both_loops(eng.model, packed, lstm["prompt"],
                                         9, GREEDY, ragged=ragged,
                                         device="cuda")
        assert torch.equal(t1, t2)
        for key in ("cache", "logits", "pos", "done", "emitted"):
            assert _same_tree(s1[key], s2[key]), key


@needs_card
def test_engine_keeps_one_kv_cache_on_card(qwen):
    """On the card the transformer's prefill builds in the static cache
    the captured graph decodes in: the graph's cache is that one, and a
    call that returns its state gets a copy of it."""
    m = qwen["model"]
    p = transformer_params_from_numpy(
        qwen["cfg"], jax.tree.map(np.asarray, qwen["jparams"]), "cuda")
    eng = ServeEngine(m, max_len=MAX_LEN, device="cuda")
    tokens = torch.as_tensor(np.random.default_rng(6).integers(
        0, qwen["cfg"].vocab_size, (2, 6)), device="cuda")
    toks = eng.generate(p, tokens, 5)
    static = eng.graphs.static_cache(m, 2, MAX_LEN, "cuda")
    loop = next(iter(eng.graphs._loops.values()))
    assert all(a is b for a, b in zip(runtime.leaves(loop.carry["cache"]),
                                      runtime.leaves(static)))
    toks2, st = eng.generate(p, tokens, 5, return_state=True)
    assert torch.equal(toks, toks2)
    assert all(a is not b and torch.equal(a, b) for a, b in
               zip(runtime.leaves(st["cache"]), runtime.leaves(static)))

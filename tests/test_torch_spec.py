"""The port's speculative decoding on the CPU, against the JAX reference
(``repro.spec``, on its ``ref`` backend as ``tests/test_spec.py`` runs it)
on the same weights: the reference test's 2-layer LSTM (X=16, H=32, V=50)
as target, with drafts made from the same numpy arrays in both packages.

Greedy speculative decode must give the port's target-only greedy tokens
and the reference's speculative tokens, token for token, with the same
round counters, for every draft variant and k; plus the sampling
distributions, the acceptance rules, the k-token verify, the rewind
contract, the draft's scan prefill, the engine's ragged and k=0 cases,
the CLI and the positional-cache rejection."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import LSTMConfig as JConfig, LSTMModel as JModel
from repro.serving import SamplingConfig as JSampling
from repro.serving import ServeEngine as JEngine
from repro.serving import sample_dist as j_sample_dist
from repro.spec import DraftModel as JDraft
from repro.spec import accept_length as j_accept_length
from repro.spec import greedy_accept as j_greedy_accept
from repro.spec import residual_dist as j_residual_dist
from repro.spec import spec_decode_loop as j_spec_decode_loop
from repro.spec import verify_chain as j_verify_chain
from repro.sparse import DeltaGateConfig as JDelta
from repro.sparse import QuantConfig as JQuantConfig
from repro.sparse import lstm_policy as jlstm_policy
from repro.sparse import use_backend as j_use_backend
from repro_torch.models import (LSTMConfig, LSTMModel, params_from_numpy,
                                quant_plan_from_scales)
from repro_torch.models import layers as L
from repro_torch.serving import (SamplingConfig, ServeEngine, sample,
                                 sample_dist, sample_from_dist,
                                 sample_with_dist)
from repro_torch.sparse import DeltaGateConfig, QuantConfig, lstm_policy
from repro_torch.spec import (DraftModel, accept_length, greedy_accept,
                              rejection_accept, residual_dist, rollback,
                              spec_decode_loop, verify_chain)

MAX_LEN = 40
GREEDY = SamplingConfig(eos_id=-1)
LOGIT_ATOL = 1e-6   # float32 sums in another order, through 2 layers
DIST_ATOL = 1e-7    # softmax of the same logits in two frameworks


@pytest.fixture(scope="module")
def lstm():
    kw = dict(input_size=16, hidden=32, num_layers=2, vocab_size=50)
    jmodel = JModel(JConfig("t", **kw))
    jparams = jmodel.init(jax.random.key(0))
    model = LSTMModel(LSTMConfig("t", **kw))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    prompt = np.asarray(jax.random.randint(jax.random.key(1), (3, 7), 0, 50))
    calib = np.random.default_rng(9).integers(0, 50, (2, 8))
    return dict(jmodel=jmodel, jparams=jparams, model=model, params=params,
                prompt=prompt, calib=calib, cfg=model.cfg, drafts={})


def _drafts(lstm, variant):
    """One draft serving variant in both packages, from the same weights:
    (reference DraftModel, port DraftModel)."""
    if variant in lstm["drafts"]:
        return lstm["drafts"][variant]
    jm, jp, m, p = (lstm[k] for k in ("jmodel", "jparams", "model",
                                      "params"))
    if variant == "dense":
        out = JDraft(jm, jp), DraftModel(m, p)
    elif variant == "packed":
        plan = jlstm_policy(0.6, 0.4, backend="ref").compile(jp)
        jpacked, _ = plan.pack(*plan.prune(jp))
        tplan = lstm_policy(0.6, 0.4).compile(p)
        packed, _ = tplan.pack(*tplan.prune(p))
        out = JDraft(jm, jpacked), DraftModel(m, packed)
    else:
        jrules, rules = ({"delta": JDelta()}, {"delta": DeltaGateConfig()}) \
            if variant == "delta0" else \
            ({"quant": JQuantConfig("int8")}, {"quant": QuantConfig("int8")})
        calib = lstm["calib"] if variant == "q8" else None
        jeng = JEngine(jm, jm.cfg, max_len=MAX_LEN, batch=3,
                       sparsity=jlstm_policy(0.6, 0.4, backend="ref",
                                             **jrules))
        eng = ServeEngine(m, max_len=MAX_LEN, device="cpu",
                          sparsity=lstm_policy(0.6, 0.4, **rules))
        jd, _ = jeng.prepare(jp, calib=None if calib is None
                             else jnp.asarray(calib))
        d, _ = eng.prepare(p, calib=None if calib is None
                           else torch.from_numpy(calib))
        if variant == "q8":
            # both packages draft with the reference's calibrated scales
            eng.model = eng.model.with_quant(quant_plan_from_scales(
                jeng.model.quant.scheme, jeng.model.quant.act_scales))
        out = JDraft(jeng.model, jd), DraftModel(eng.model, d)
    lstm["drafts"][variant] = out
    return out


def _engines(lstm):
    return (JEngine(lstm["jmodel"], lstm["jmodel"].cfg, max_len=MAX_LEN,
                    batch=3),
            ServeEngine(lstm["model"], max_len=MAX_LEN, device="cpu"))


# ---------------------------------------------------------------- sampling

def test_sample_with_dist_greedy_one_hot():
    logits = torch.from_numpy(
        np.random.default_rng(0).normal(size=(4, 11)).astype(np.float32))
    ids, dist = sample_with_dist(None, logits, GREEDY)
    assert torch.equal(ids, logits.argmax(-1).to(torch.int32))
    assert torch.equal(dist, torch.eye(11)[ids.long()])
    assert torch.equal(sample(None, logits, GREEDY), ids)
    want = j_sample_dist(jnp.asarray(logits.numpy()), JSampling())
    np.testing.assert_array_equal(dist.numpy(), np.asarray(want))


@pytest.mark.parametrize("kw", [dict(temperature=0.7, top_k=4),
                                dict(temperature=1.3, top_p=0.8),
                                dict(temperature=0.9)])
def test_sample_with_dist_temperature(kw):
    cfg = SamplingConfig(**kw)
    logits = torch.from_numpy(
        np.random.default_rng(1).normal(size=(5, 16)).astype(np.float32))
    g1, g2 = (torch.Generator().manual_seed(3) for _ in range(2))
    ids, dist = sample_with_dist(g1, logits, cfg)
    # the ids are what ``sample`` draws from the same generator state
    assert torch.equal(ids, sample(g2, logits, cfg))
    want = j_sample_dist(jnp.asarray(logits.numpy()), JSampling(**kw))
    np.testing.assert_allclose(dist.numpy(), np.asarray(want), rtol=0,
                               atol=DIST_ATOL)
    np.testing.assert_allclose(dist.sum(-1).numpy(), 1.0, rtol=1e-5)
    if "top_k" in kw:
        assert ((dist > 1e-9).sum(-1) <= kw["top_k"]).all()
    ids2 = sample_from_dist(torch.Generator().manual_seed(4), dist, cfg)
    assert (dist.gather(-1, ids2.long()[:, None]) > 0).all()


def test_sample_from_dist_greedy_argmax():
    dist = torch.tensor([[0.1, 0.7, 0.2], [0.5, 0.2, 0.3]])
    assert sample_from_dist(None, dist, GREEDY).tolist() == [1, 0]


def test_sample_from_dist_draws_by_distribution():
    """Temperature draws from an explicit distribution follow it: the
    empirical frequencies of 20,000 draws within 0.015 of it (about 5
    standard deviations), zero-mass entries never drawn."""
    dist = torch.tensor([0.5, 0.3, 0.2, 0.0, 0.0])
    n = 20000
    ids = sample_from_dist(torch.Generator().manual_seed(5),
                           dist.expand(n, 5), SamplingConfig(temperature=1.0))
    freq = torch.bincount(ids.long(), minlength=5).float() / n
    assert (freq[3:] == 0).all()
    np.testing.assert_allclose(freq.numpy(), dist.numpy(), atol=0.015)


# ---------------------------------------------------------------- accept

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k", [1, 3, 6])
def test_accept_rules_match_jax(seed, k):
    """accept_length, greedy_accept and residual_dist on the same arrays:
    integers equal, distributions within 1e-7."""
    rng = np.random.default_rng(seed)
    B, V = 4, 9
    ok = rng.random((B, k)) < 0.7
    np.testing.assert_array_equal(accept_length(torch.from_numpy(ok)).numpy(),
                                  np.asarray(j_accept_length(jnp.asarray(ok))))
    logits = rng.normal(size=(B, k + 1, V)).astype(np.float32)
    toks = np.argmax(logits[:, :k], -1)
    toks[rng.random((B, k)) < 0.3] = 0            # some mismatches
    got = greedy_accept(torch.from_numpy(toks), torch.from_numpy(logits))
    want = j_greedy_accept(jnp.asarray(toks), jnp.asarray(logits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    p = rng.dirichlet(np.ones(V), (B, k + 1)).astype(np.float32)
    q = rng.dirichlet(np.ones(V), (B, k)).astype(np.float32)
    q[0] = p[0, :k]                                # all-zero residual row
    a = rng.integers(0, k + 1, (B,)).astype(np.int32)
    a[0] = 0
    got = residual_dist(torch.from_numpy(p), torch.from_numpy(q),
                        torch.from_numpy(a))
    want = j_residual_dist(jnp.asarray(p), jnp.asarray(q), jnp.asarray(a))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=DIST_ATOL)


def test_accept_units():
    ok = torch.tensor([[1, 1, 0, 1], [1, 1, 1, 1], [0, 1, 1, 1]]).bool()
    assert accept_length(ok).tolist() == [2, 4, 0]
    logits = torch.zeros((1, 3, 5))
    logits[0, 0, 2] = logits[0, 1, 4] = logits[0, 2, 1] = 1.0
    assert greedy_accept(torch.tensor([[2, 4, 0]]), logits).tolist() == [2]
    p = torch.nn.functional.one_hot(torch.tensor([[1, 3, 5]]), 6).float()
    q = torch.nn.functional.one_hot(torch.tensor([[1, 2]]), 6).float()
    assert torch.equal(residual_dist(p, q, torch.tensor([1])),
                       torch.nn.functional.one_hot(torch.tensor([3]),
                                                   6).float())
    assert torch.equal(residual_dist(p, q, torch.tensor([2])), p[:, 2])


def test_rejection_accept_by_distribution():
    """q = p accepts every proposal; otherwise slot 1 accepts with
    probability min(1, p(d)/q(d)), held over 20,000 rows within 0.015."""
    V, k = 7, 4
    rng = np.random.default_rng(0)
    p = torch.from_numpy(rng.dirichlet(np.ones(V), (3, k + 1)).astype(
        np.float32))
    toks = p[:, :k].argmax(-1).to(torch.int32)
    a = rejection_accept(torch.Generator().manual_seed(1), toks, p, p[:, :k])
    assert a.tolist() == [k, k, k]
    n = 20000
    p1 = torch.tensor([0.2, 0.5, 0.3]).expand(n, 2, 3)
    q1 = torch.tensor([0.6, 0.3, 0.1]).expand(n, 1, 3)
    for d, want in ((0, 0.2 / 0.6), (1, 1.0), (2, 1.0)):
        a = rejection_accept(torch.Generator().manual_seed(2 + d),
                             torch.full((n, 1), d, dtype=torch.int32), p1, q1)
        assert abs(float(a.float().mean()) - want) < 0.015


# ------------------------------------------------------ verify + rewind

def _prefill(model, params, prompt):
    return model.prefill(params, torch.as_tensor(prompt), MAX_LEN)


def test_verify_chain_matches_jax_and_sequential(lstm):
    """A (B, 3) block: logits within 1e-6 of the reference's verify_chain
    with the same argmax, and bitwise the port's own sequential decode
    steps; the checkpoints are the per-token states."""
    m, p = lstm["model"], lstm["params"]
    rng = np.random.default_rng(2)
    block = rng.integers(0, 50, (3, 3)).astype(np.int32)
    with j_use_backend("ref"):
        _, jc = lstm["jmodel"].prefill(lstm["jparams"],
                                       jnp.asarray(lstm["prompt"]), MAX_LEN)
        want, _, _ = j_verify_chain(lstm["jmodel"], lstm["jparams"], jc,
                                    jnp.asarray(block),
                                    jnp.full((3,), 7, jnp.int32))
    _, cache = _prefill(m, p, lstm["prompt"])
    got, cache_v, states = verify_chain(m, p, cache, torch.from_numpy(block),
                                        torch.full((3,), 7))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGIT_ATOL)
    np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                  np.asarray(want).argmax(-1))
    seq, c = [], cache
    for j in range(3):
        lg, c = m.decode_step(p, c, torch.from_numpy(block[:, j:j + 1]), 7 + j)
        seq.append(lg[:, 0])
        assert torch.equal(states[0][j + 1], c["layers"][0]["c"])
    assert torch.equal(got, torch.stack(seq, 1))
    assert torch.equal(states[0][0], cache["layers"][0]["c"])
    assert len(states) == 4 and states[0].shape == (4, 3, 32)
    assert torch.equal(cache_v["layers"][1]["h"], c["layers"][1]["h"])


@pytest.mark.parametrize("delta", [False, True])
def test_rewind_decode_matches_fresh_from_prefill(lstm, delta):
    """Decode 3 tokens, roll back, decode different tokens: bitwise the
    trajectory that never saw the first ones (full and partial rewind),
    for the plain cache and the delta cache's seven leaves a layer."""
    m, p = lstm["model"], lstm["params"]
    if delta:
        m = m.with_delta(DeltaGateConfig())
    rng = np.random.default_rng(3)
    A = torch.from_numpy(rng.integers(0, 50, (3, 3)))
    Bt = torch.from_numpy(rng.integers(0, 50, (3, 3)))
    pos = torch.full((3,), 7)
    _, cache = _prefill(m, p, lstm["prompt"])
    _, cache_a, states = verify_chain(m, p, cache, A, pos)
    back = rollback(m, cache_a, states, torch.zeros(3, dtype=torch.int32))
    got, _, _ = verify_chain(m, p, back, Bt, pos)
    want, _, _ = verify_chain(m, p, cache, Bt, pos)
    assert torch.equal(got, want)
    # keep A's first token on rows 0 and 2, none of it on row 1
    commit = torch.tensor([1, 0, 1], dtype=torch.int32)
    back = rollback(m, cache_a, states, commit)
    _, fresh, _ = verify_chain(m, p, cache, A[:, :1], pos)
    for name in ("c", "h"):
        leaf = back["layers"][1][name]
        assert torch.equal(leaf[0], fresh["layers"][1][name][0])
        assert torch.equal(leaf[1], cache["layers"][1][name][1])
    if delta:
        assert set(back["layers"][0]) == {"c", "h", "x_ref", "h_ref", "m",
                                          "nx", "nh"}
        assert torch.equal(back["layers"][0]["m"][2],
                           fresh["layers"][0]["m"][2])


# ------------------------------------------------------------------ draft

def test_draft_scan_prefill_matches_model_prefill(lstm):
    """The scan prefill primes the same state as the model's own prefill,
    bitwise on the port's plain versions, and within 1e-6 of the
    reference's scan prefill."""
    jd, d = _drafts(lstm, "packed")
    draft = DraftModel(d.model, d.params, scan_prefill=True)
    prompt = torch.as_tensor(lstm["prompt"])
    assert draft._can_scan_prefill(d.params, prompt, None)
    l_scan, s_scan = draft.prefill(d.params, prompt, MAX_LEN)
    l_ref, s_ref = d.model.prefill(d.params, prompt, MAX_LEN)
    assert torch.equal(l_scan, l_ref)
    for lg, lr in zip(s_scan["layers"], s_ref["layers"]):
        assert torch.equal(lg["c"], lr["c"]) and torch.equal(lg["h"], lr["h"])
    with j_use_backend("ref"):
        jl, js = JDraft(jd.model, jd.params, scan_prefill=True).prefill(
            jd.params, jnp.asarray(lstm["prompt"]), MAX_LEN)
    np.testing.assert_allclose(l_scan.numpy(), np.asarray(jl), rtol=0,
                               atol=LOGIT_ATOL)
    for lg, jlay in zip(s_scan["layers"], js["layers"]):
        np.testing.assert_allclose(lg["c"].numpy(), np.asarray(jlay["c"]),
                                   rtol=0, atol=LOGIT_ATOL)


@pytest.mark.parametrize("variant,ok", [("packed", True), ("dense", False),
                                        ("delta0", False), ("q8", False)])
def test_draft_scan_prefill_rule(lstm, variant, ok):
    """The reference's rule: packed float params with no delta or quant,
    exact-length prompts of at most 64 tokens unless forced."""
    _, d = _drafts(lstm, variant)
    prompt = torch.as_tensor(lstm["prompt"])
    assert d._can_scan_prefill(d.params, prompt, None) is ok
    assert not d._can_scan_prefill(d.params, prompt, torch.tensor([7, 6, 5]))
    long = torch.zeros((1, 65), dtype=torch.long)
    assert not d._can_scan_prefill(d.params, long, None)
    forced = DraftModel(d.model, d.params, scan_prefill=True)
    assert forced._can_scan_prefill(d.params, long, None) is ok
    off = DraftModel(d.model, d.params, scan_prefill=False)
    assert not off._can_scan_prefill(d.params, prompt, None)


def test_draft_rejects_positional_cache_model():
    class KV:
        def cache_defs(self, batch, max_len):
            return {"k": L.PSpec((batch, max_len, 4),
                                 axes=("batch", "cache_seq", "kv"))}
        init_cache = prefill = decode_step = lambda *a, **k: None

    with pytest.raises(TypeError, match="positional"):
        DraftModel(KV(), None)
    with pytest.raises(TypeError, match="serving contract"):
        DraftModel(object(), None)


def test_cache_defs_name_their_axes(lstm):
    m = lstm["model"].with_delta(DeltaGateConfig())
    defs = m.cache_defs(2, 4)["layers"][0]
    assert {k: d.axes for k, d in defs.items()} == {
        "c": ("batch", "lstm_hidden"), "h": ("batch", "lstm_hidden"),
        "x_ref": ("batch", "embed"), "h_ref": ("batch", "lstm_hidden"),
        "m": ("batch", "lstm_gates"), "nx": ("batch",), "nh": ("batch",)}
    with pytest.raises(ValueError, match="axes"):
        L.PSpec((2, 3), axes=("batch",))


# ------------------------------------------------------------ losslessness

@pytest.mark.parametrize("variant", ["dense", "packed", "delta0", "q8"])
@pytest.mark.parametrize("k", [1, 4, 8])
def test_greedy_spec_lossless_and_matches_jax(lstm, variant, k):
    """Greedy speculative tokens are the port's target-only greedy tokens
    and the reference's speculative tokens, with the reference's rounds,
    drafted and accepted counters."""
    jeng, eng = _engines(lstm)
    jd, d = _drafts(lstm, variant)
    jprompt = jnp.asarray(lstm["prompt"])
    with j_use_backend("ref"):
        jtoks, jst = jeng.generate(lstm["jparams"], jprompt, 8, draft=jd,
                                   spec_k=k, return_state=True)
    base = eng.generate(lstm["params"], lstm["prompt"], 8)
    toks, st = eng.generate(lstm["params"], lstm["prompt"], 8, draft=d,
                            spec_k=k, return_state=True)
    assert torch.equal(toks, base)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    for key in ("rounds", "drafted", "accepted", "emitted", "pos"):
        np.testing.assert_array_equal(st[key].numpy(), np.asarray(jst[key]),
                                      err_msg=key)


def test_greedy_spec_lossless_with_eos(lstm):
    """EOS and pad emission as decode_loop's: an eos id the greedy
    continuation emits mid-stream."""
    jeng, eng = _engines(lstm)
    free = eng.generate(lstm["params"], lstm["prompt"], 8)
    eos = int(free[0, 2])
    samp = SamplingConfig(eos_id=eos)
    base = eng.generate(lstm["params"], lstm["prompt"], 8, sampling=samp)
    jd, d = _drafts(lstm, "packed")
    toks, st = eng.generate(lstm["params"], lstm["prompt"], 8, sampling=samp,
                            draft=d, spec_k=4, return_state=True)
    assert (base[0] == samp.pad_id).any()       # the eos fired
    assert torch.equal(toks, base)
    with j_use_backend("ref"):
        jtoks, jst = jeng.generate(lstm["jparams"],
                                   jnp.asarray(lstm["prompt"]), 8,
                                   sampling=JSampling(eos_id=eos), draft=jd,
                                   spec_k=4, return_state=True)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    for key in ("rounds", "drafted", "accepted", "done"):
        np.testing.assert_array_equal(st[key].numpy(), np.asarray(jst[key]))


@pytest.mark.parametrize("k", [1, 4])
def test_spec_loop_budget_and_done_match_jax(lstm, k):
    """``spec_decode_loop`` with a per-row budget below ``steps`` and a
    row done before the first round: the reference's tokens, emitted and
    round counters; the budgeted rows emit the first ``budget`` target-only
    greedy tokens, the done row pads only."""
    steps, budget, done = 8, [3, 5, 6], [False, True, False]
    jd, d = _drafts(lstm, "packed")
    jm, jp, m, p = (lstm[key] for key in ("jmodel", "jparams", "model",
                                          "params"))
    prompt, S = lstm["prompt"], lstm["prompt"].shape[1]
    jsamp = JSampling(eos_id=-1)
    with j_use_backend("ref"):
        jprompt = jnp.asarray(prompt)
        jlogits, jcache = jm.prefill(jp, jprompt, MAX_LEN)
        _, jdstate = jd.prefill(jd.params, jprompt, MAX_LEN)
        jtoks, jst = j_spec_decode_loop(
            jm, jd, jp, jd.params, jcache, jdstate,
            j_sample_dist(jlogits[:, -1], jsamp), S, jax.random.key(0),
            steps, k, jsamp, done=jnp.asarray(done),
            budget=jnp.asarray(budget, jnp.int32), limit=MAX_LEN)
    tprompt = torch.from_numpy(prompt)
    logits, cache = m.prefill(p, tprompt, MAX_LEN)
    _, dstate = d.prefill(d.params, tprompt, MAX_LEN)
    toks, st = spec_decode_loop(
        m, d, p, d.params, cache, dstate, sample_dist(logits[:, -1], GREEDY),
        S, None, steps, k, GREEDY, done=torch.tensor(done),
        budget=torch.tensor(budget, dtype=torch.int32), limit=MAX_LEN)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    for key in ("rounds", "drafted", "accepted", "emitted", "done", "pos"):
        np.testing.assert_array_equal(st[key].numpy(), np.asarray(jst[key]),
                                      err_msg=key)
    _, eng = _engines(lstm)
    base = eng.generate(p, prompt, steps)
    assert st["emitted"].tolist() == [3, 0, 6]
    assert torch.equal(toks[0, :3], base[0, :3])
    assert torch.equal(toks[2, :6], base[2, :6])
    assert (toks[1] == GREEDY.pad_id).all()
    assert (toks[0, 3:] == GREEDY.pad_id).all()


def test_spec_acceptance_accounting(lstm):
    """A draft with the target's own weights accepts everything: two full
    rounds of 1 + 3 committed tokens for 8 steps."""
    _, eng = _engines(lstm)
    draft = DraftModel(lstm["model"], lstm["params"])
    toks, st = eng.generate(lstm["params"], lstm["prompt"][:2], 8,
                            draft=draft, spec_k=3, return_state=True)
    assert st["rounds"].tolist() == [2, 2]
    assert st["emitted"].tolist() == [8, 8]
    assert st["accepted"].tolist() == [6, 6]
    assert st["drafted"].tolist() == [6, 6]


def test_spec_k0_and_ragged_lengths(lstm):
    """spec_k=0 verifies one token a round (plain decode); a ragged batch
    (``lengths=``) decodes speculatively to its target-only tokens."""
    _, eng = _engines(lstm)
    _, d = _drafts(lstm, "packed")
    p, prompt = lstm["params"], lstm["prompt"]
    base = eng.generate(p, prompt, 8)
    toks, st = eng.generate(p, prompt, 8, draft=d, spec_k=0,
                            return_state=True)
    assert torch.equal(toks, base)
    assert st["rounds"].tolist() == [8, 8, 8]
    assert st["drafted"].tolist() == [0, 0, 0]
    lengths = [7, 4, 6]
    base = eng.generate(p, prompt, 6, lengths=lengths)
    toks = eng.generate(p, prompt, 6, lengths=lengths, draft=d, spec_k=3)
    assert torch.equal(toks, base)


def test_temperature_spec_matches_target_distribution(lstm):
    """The rejection-sampling path draws from the target's chain: over
    3000 rows of one prompt, the second token given the most frequent
    first token follows the target's next-token distribution within a
    total variation of 0.06 (about 4 standard deviations), and the
    counters are sound."""
    m, p = lstm["model"], lstm["params"]
    _, eng = _engines(lstm)
    _, d = _drafts(lstm, "packed")
    samp = SamplingConfig(temperature=1.0, top_k=4)
    n = 3000
    prompt = np.repeat(lstm["prompt"][:1], n, axis=0)
    toks, st = eng.generate(p, prompt, 2, sampling=samp, draft=d, spec_k=3,
                            rng=torch.Generator().manual_seed(6),
                            return_state=True)
    assert toks.shape == (n, 2) and ((toks >= 0) & (toks < 50)).all()
    assert (st["emitted"] == 2).all()
    assert ((st["accepted"] >= 0) & (st["accepted"] <= st["drafted"])).all()
    first = int(torch.mode(toks[:, 0]).values)
    rows = toks[:, 0] == first
    logits, cache = m.prefill(p, torch.as_tensor(prompt[:1]), MAX_LEN)
    lg, _ = m.decode_step(p, cache, torch.tensor([[first]]), 7)
    want = sample_dist(lg[0, -1], samp)
    got = torch.bincount(toks[rows, 1].long(), minlength=50).float()
    tv = 0.5 * (got / got.sum() - want).abs().sum()
    assert int(rows.sum()) > 500 and float(tv) < 0.06


# ------------------------------------------------------------------- CLI

def test_serve_cli_with_a_draft_on_cpu(capsys):
    """``--draft lstm_imdb --draft-brds``: the classifier configuration as
    a packed language-model draft; the greedy ids are those of the run
    without a draft, and the acceptance line is printed."""
    from repro_torch.launch import serve
    argv = ["--arch", "lstm_ptb", "--smoke", "--brds", "--device", "cpu",
            "--batch", "2", "--prompt-len", "5", "--gen", "6"]
    serve.main(argv)
    plain = capsys.readouterr().out
    serve.main(argv + ["--draft", "lstm_imdb", "--draft-brds", "--spec-k",
                       "4"])
    out = capsys.readouterr().out
    assert "draft=lstm_imdb spec_k=4" in out and "draft BRDS:" in out
    assert "spec: acceptance=" in out and "drafted over" in out
    ids = [ln for ln in out.splitlines() if ln.startswith("sample ids:")]
    assert ids == [ln for ln in plain.splitlines()
                   if ln.startswith("sample ids:")]


@pytest.mark.parametrize("extra", [["--draft-delta", "0"],
                                   ["--draft-brds", "--draft-quant", "int8",
                                    "--spec-k", "2"]])
def test_serve_cli_draft_variants_on_cpu(capsys, extra):
    from repro_torch.launch import serve
    serve.main(["--arch", "lstm_ptb",
                "--smoke", "--brds", "--device", "cpu", "--batch", "2",
                "--prompt-len", "4", "--gen", "3", "--draft", "lstm_ptb",
                *extra])
    assert "spec: acceptance=" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [["--draft-brds"],
                                  ["--draft", "lstm_ptb", "--draft-quant",
                                   "int8"],
                                  ["--draft", "gpt"]])
def test_serve_cli_rejects_bad_draft_flags(argv):
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.main(["--arch", "lstm_ptb", "--smoke", "--device", "cpu", *argv])


def test_spec_import_loads_no_jax():
    """The speculative package and the engine's draft route pull in
    neither JAX nor the reference package, and build no kernel."""
    src = Path(__file__).resolve().parents[1] / "src"
    code = ("import sys, repro_torch.spec, repro_torch.serving.engine, "
            "repro_torch.kernels._build as b\n"
            "assert not b._libs\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env={**os.environ, "PYTHONPATH": str(src)})

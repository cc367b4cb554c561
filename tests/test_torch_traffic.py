"""The port's ``traffic`` package and the scheduler under traffic, on the
CPU, against the JAX reference on the same inputs.

The pool, admission queue, load generator and metrics are the port's own
copies: their outputs must equal the reference's on the same calls. The
scheduler (``ContinuousBatchingEngine``: bucketed prefill, streaming,
deadlines, random arrivals through tiny pools at dispatch depths 1-3, the
closed-loop trace driver) must give every request the tokens the JAX
scheduler gives it, and its batch=1 lockstep ``ServeEngine`` decode, on
weights crossed from the reference, for dense, packed, Θ=0 delta and
calibrated int8 params (the counterparts of ``tests/test_traffic.py``)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import traffic as jtraffic
from repro.models import LSTMConfig as JConfig, LSTMModel as JModel
from repro.serving import ContinuousBatchingEngine as JSched
from repro.serving import ServeEngine as JEngine
from repro.sparse import DeltaGateConfig as JDelta
from repro.sparse import QuantConfig as JQuant
from repro.sparse import lstm_policy as jlstm_policy
from repro.sparse import use_backend as j_use_backend
from repro_torch.models import (LSTMConfig, LSTMModel, params_from_numpy,
                                quant_plan_from_scales)
from repro_torch.serving import ServeEngine, prefill_accepts_length
from repro_torch.serving.scheduler import (ContinuousBatchingEngine,
                                           Finished, TokenEvent)
from repro_torch.sparse import DeltaGateConfig, QuantConfig, lstm_policy
import repro_torch.traffic as ttraffic
from repro_torch.traffic import (DispatchQueue, LoadConfig, make_prompts,
                                 percentile, poisson_trace, serve_trace,
                                 summarize)

CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def lstm():
    kw = dict(input_size=8, hidden=16, num_layers=2, vocab_size=32)
    jmodel = JModel(JConfig("t", **kw))
    jparams = jmodel.init(jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return dict(cfg=LSTMConfig("t", **kw), model=LSTMModel(
        LSTMConfig("t", **kw)), params=params, jmodel=jmodel,
        jparams=jparams)


def _packed(lstm, **rules):
    """(port model, params, reference model, params) prepared by both
    engines with lstm_policy(0.75, 0.5, **rules); int8 runs on the
    reference's calibrated scales in both."""
    jrules = {}
    if "delta" in rules:
        jrules["delta"] = JDelta(theta_x=0.0, theta_h=0.0)
    if "quant" in rules:
        jrules["quant"] = JQuant("int8")
    calib = np.asarray(jax.random.randint(jax.random.key(9), (2, 12), 0,
                                          lstm["cfg"].vocab_size))
    jeng = JEngine(lstm["jmodel"], lstm["jmodel"].cfg, max_len=48, batch=1,
                   sparsity=jlstm_policy(0.75, 0.5, backend="ref", **jrules))
    eng = ServeEngine(lstm["model"], max_len=48, device="cpu",
                      sparsity=lstm_policy(0.75, 0.5, **rules))
    q = "quant" in rules
    jp, _ = jeng.prepare(lstm["jparams"], calib=jnp.asarray(calib) if q
                         else None)
    p, _ = eng.prepare(lstm["params"], calib=torch.from_numpy(calib) if q
                       else None)
    model = eng.model
    if q:
        model = model.with_quant(quant_plan_from_scales(
            jeng.model.quant.scheme, jeng.model.quant.act_scales))
    return model, p, jeng.model, jp


def _jax_tokens(jmodel, jparams, prompts, budgets, **kw):
    """Each request's tokens from the JAX scheduler (ref backend)."""
    with j_use_backend("ref"):
        sched = JSched(jmodel, jparams, **kw)
        uids = [sched.submit(p, b) for p, b in zip(prompts, budgets)]
        got = sched.run()
    return [np.asarray(got[u]) for u in uids]


# ---------------------------------------------------------------- loadgen

def test_poisson_trace_matches_reference():
    kw = dict(rate=10.0, num_requests=40, deadline=1.5, priorities=(0, 1),
              seed=3)
    a, ja = poisson_trace(LoadConfig(**kw)), jtraffic.poisson_trace(
        jtraffic.LoadConfig(**kw))
    assert [tuple(vars(x).values()) for x in a] == \
        [tuple(vars(x).values()) for x in ja]
    assert a == poisson_trace(LoadConfig(**kw))
    assert a != poisson_trace(LoadConfig(**dict(kw, seed=4)))
    ts = [x.t for x in a]
    assert ts == sorted(ts) and ts[0] > 0
    p, jp = make_prompts(a, vocab=32, seed=3), jtraffic.make_prompts(
        ja, 32, seed=3)
    assert all(np.array_equal(x, y) and x.dtype == np.int32
               for x, y in zip(p, jp))
    with pytest.raises(ValueError):
        poisson_trace(LoadConfig(rate=0.0, num_requests=1))


# ------------------------------------------------------------------- pool

def _pool_script(mod):
    """The reference test's slot-pool lifecycle; returns what it saw."""
    seen = []
    pool = mod.SlotPool(3)
    seen.append((pool.free_count, len(pool)))
    s0, s1 = pool.alloc(), pool.alloc()
    pool.seat(s0, mod.SlotInfo(uid=7, prompt_len=4, remaining=2))
    pool.seat(s1, mod.SlotInfo(uid=8, prompt_len=5, remaining=3))
    seen.append((s0, s1, pool.owner(s0), pool.info(s0).slot,
                 sorted(pool.active())))
    snapshot = pool.owners()
    with pytest.raises(RuntimeError):       # double-seat is a bug
        pool.seat(s0, mod.SlotInfo(uid=9, prompt_len=1, remaining=1))
    freed = pool.free(s0)
    seen.append((freed.uid, pool.owner(s0), snapshot[s0]))
    with pytest.raises(RuntimeError):
        pool.free(s0)
    seen.append(pool.alloc())               # LIFO: freed slot reused first
    pool.release_unseated(s0)
    seen.append((pool.alloc_many(5), pool.alloc(), repr(pool)))
    with pytest.raises(ValueError):
        mod.SlotPool(0)
    return seen


def test_slot_pool_lifecycle_matches_reference():
    seen = _pool_script(ttraffic)
    assert seen == _pool_script(jtraffic)
    assert seen[3] == seen[1][0]            # the freed slot came back first
    assert len(seen[4][0]) == 2 and seen[4][1] is None


# -------------------------------------------------------------- admission

def _admission_script(mod):
    def req(uid, *, deadline=None, priority=0, arrival=0.0):
        return mod.QueuedRequest(uid, None, 4, 4, deadline=deadline,
                                 priority=priority, arrival=arrival)
    out = []
    q = mod.AdmissionQueue(max_queue=3)
    out += [q.push(req(0, deadline=9.0, arrival=0.0)),
            q.push(req(1, deadline=2.0, arrival=0.1)),
            q.push(req(2, priority=1, arrival=0.2))]
    out.append(q.push(req(3, deadline=1.0, arrival=0.3)).uid)
    out.append([r.uid for r in q.pop(3)])
    q2 = mod.AdmissionQueue(max_queue=1)
    q2.push(req(5, priority=5))
    out.append(q2.push(req(6, priority=0)).uid)
    q3 = mod.AdmissionQueue()
    for r in (req(7, deadline=1.0), req(8, deadline=5.0), req(9)):
        q3.push(r)
    out.append(([r.uid for r in q3.expire(now=2.0)], len(q3),
                q3.peek().uid))
    with pytest.raises(ValueError):
        mod.AdmissionQueue(max_queue=0)
    return out


def test_admission_queue_ordering_and_shedding_matches_reference():
    got = _admission_script(ttraffic)
    assert got == _admission_script(jtraffic)
    # the worst (lowest priority, latest deadline) shed; priority band
    # first, then deadline-monotonic; an incoming worst bounces back
    assert got[3:6] == [0, [2, 3, 1], 6] and got[6] == ([7], 2, 8)


def test_dispatch_queue_depth_and_events():
    q = DispatchQueue(2)
    assert q.want_dispatch and not q
    a = q.push(torch.zeros(2, 3), [1, None], event="e0")
    q.push(torch.ones(2, 3), (None, 4))
    assert not q.want_dispatch and len(q) == 2
    with pytest.raises(RuntimeError):
        q.push(None, ())
    got = q.harvest()
    assert got is a and got.seq == 0 and got.owners == (1, None)
    assert got.event == "e0" and got.counters is None
    assert q.harvest().seq == 1 and q.harvest() is None
    with pytest.raises(ValueError):
        DispatchQueue(0)


# ---------------------------------------------------------------- metrics

def _records(mod):
    R = mod.RequestRecord
    return [R(0, scheduled=0.0, deadline=2.0, first_token=0.5, finished=1.0,
              tokens=6, reason="done"),
            R(1, scheduled=0.0, deadline=0.8, first_token=0.4, finished=1.0,
              tokens=4, reason="done"),
            R(2, scheduled=0.1, tokens=0, reason="expired"),
            R(3, scheduled=0.2, tokens=0, reason="rejected")]


def test_metrics_records_and_summary_match_reference():
    recs = _records(ttraffic)
    assert recs[0].ttft == 0.5
    assert recs[0].tpot == pytest.approx(0.1)
    assert recs[2].ttft is None and recs[2].tpot is None
    assert recs[0].in_deadline and not recs[1].in_deadline
    s = summarize(recs, wall=2.0, offered_rps=5.0)
    assert s == jtraffic.summarize(_records(jtraffic), wall=2.0,
                                   offered_rps=5.0)
    assert s["goodput_tps"] == pytest.approx(3.0)   # late tokens excluded
    assert s["p50_ttft_ms"] == pytest.approx(450.0)
    assert math.isnan(percentile([], 50))
    xs = [0.3, 0.1, 0.7, 0.2]
    assert percentile(xs, 90) == jtraffic.percentile(xs, 90)


# ------------------------------------------------- bucketed prefill parity

@pytest.mark.parametrize("variant", ["dense", "packed", "delta0"])
def test_bucketed_prefill_bitwise(lstm, variant):
    """Padded-to-bucket prefill with length= is BITWISE the unpadded
    prefill: logits and every cache leaf."""
    if variant == "dense":
        m, p = lstm["model"], lstm["params"]
    else:
        m, p, _, _ = _packed(lstm, **({"delta": DeltaGateConfig()}
                                      if variant == "delta0" else {}))
    assert prefill_accepts_length(m)
    rng = np.random.default_rng(0)
    for L, W in ((3, 4), (5, 8), (6, 16)):
        toks = np.zeros((1, W), np.int64)
        toks[0, :L] = rng.integers(0, lstm["cfg"].vocab_size, size=L)
        lgp, cp = m.prefill(p, torch.from_numpy(toks), 24,
                            length=torch.tensor([L]))
        lgr, cr = m.prefill(p, torch.from_numpy(toks[:, :L]), 24)
        assert torch.equal(lgp, lgr)
        from repro_torch.serving.runtime import leaves
        assert all(torch.equal(a, b) for a, b in zip(leaves(cp),
                                                     leaves(cr)))


def test_bucketing_prefills_once_per_bucket(lstm):
    """Distinct prompt lengths inside one bucket share one padded prefill
    width (counted by the padded shape); tokens equal the reference's."""
    model, params = lstm["model"], lstm["params"]
    widths = []

    class Probe:
        def __getattr__(self, name):
            return getattr(model, name)

        def prefill(self, p, toks, max_len, extra=None, length=None):
            widths.append(toks.shape[1])
            return model.prefill(p, toks, max_len, extra=extra,
                                 length=length)

    sched = ContinuousBatchingEngine(Probe(), params, slots=2, max_len=32,
                                     chunk=4, **CPU)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, lstm["cfg"].vocab_size, size=(1, n))
               for n in (3, 4, 5, 6, 7, 8, 9)]
    got = []
    for p in prompts:                       # buckets: 4, 8, 16
        uid = sched.submit(p, 2)
        got.append(sched.run()[uid])
    assert sorted(set(widths)) == [4, 8, 16] and len(widths) == 7
    want = _jax_tokens(lstm["jmodel"], lstm["jparams"], prompts, [2] * 7,
                       slots=2, max_len=32, chunk=4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_unbucketed_fallback_without_length_support(lstm):
    """A model whose prefill has no ``length`` parameter serves at exact-
    length batch=1 prefill; the ragged lockstep engine refuses it."""
    model, params = lstm["model"], lstm["params"]
    widths = []

    class NoLen:
        def cache_defs(self, b, m):
            return model.cache_defs(b, m)

        def init_cache(self, b, m, device):
            return model.init_cache(b, m, device)

        def prefill(self, p, toks, max_len, extra=None):
            widths.append(toks.shape[1])
            return model.prefill(p, toks, max_len, extra=extra)

        def decode_step(self, p, c, t, pos):
            return model.decode_step(p, c, t, pos)

    nl = NoLen()
    assert not prefill_accepts_length(nl)
    sched = ContinuousBatchingEngine(nl, params, slots=2, max_len=32,
                                     chunk=4, **CPU)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, lstm["cfg"].vocab_size, size=(1, n))
               for n in (3, 5, 6)]
    uids = [sched.submit(p, 4) for p in prompts]
    got = sched.run()
    assert widths == [3, 5, 6]
    eng = ServeEngine(model, max_len=32, **CPU)
    want = _jax_tokens(lstm["jmodel"], lstm["jparams"], prompts, [4] * 3,
                       slots=2, max_len=32, chunk=4)
    for uid, p, w in zip(uids, prompts, want):
        np.testing.assert_array_equal(got[uid], w)
        np.testing.assert_array_equal(
            got[uid], eng.generate(params, torch.from_numpy(p), 4)[0])
    with pytest.raises(TypeError):
        ServeEngine(nl, max_len=32, **CPU).generate(
            params, torch.zeros((2, 4), dtype=torch.long), 2,
            lengths=[3, 4])


def test_ragged_lockstep_generate_matches_reference(lstm):
    model, params = lstm["model"], lstm["params"]
    rng = np.random.default_rng(3)
    lens = [3, 7, 5, 8]
    toks = np.zeros((4, 8), np.int32)
    for i, L in enumerate(lens):
        toks[i, :L] = rng.integers(0, lstm["cfg"].vocab_size, size=L)
    eng = ServeEngine(model, max_len=32, **CPU)
    out = eng.generate(params, torch.from_numpy(toks), 6,
                       lengths=np.asarray(lens))
    jout = JEngine(lstm["jmodel"], lstm["jmodel"].cfg, max_len=32,
                   batch=4).generate(lstm["jparams"], jnp.asarray(toks), 6,
                                     lengths=np.asarray(lens))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    for i, L in enumerate(lens):
        ref = eng.generate(params, torch.from_numpy(toks[i:i + 1, :L]), 6)
        assert torch.equal(out[i], ref[0])


# -------------------------------------------------- streaming + deadlines

def test_streaming_callbacks_and_events(lstm):
    model, params = lstm["model"], lstm["params"]
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, lstm["cfg"].vocab_size, size=(1, n))
               for n in (3, 6, 4)]
    streamed: dict[int, list] = {}
    firsts: dict[int, int] = {}

    def on_token(uid, toks, first):
        streamed.setdefault(uid, []).extend(toks)
        firsts[uid] = firsts.get(uid, 0) + bool(first)

    sched = ContinuousBatchingEngine(model, params, slots=2, max_len=32,
                                     chunk=3, on_token=on_token, **CPU)
    uids = [sched.submit(p, 7) for p in prompts]
    finished = {}
    for ev in sched.events():
        if isinstance(ev, TokenEvent):
            assert ev.tokens                 # no empty events
        elif isinstance(ev, Finished):
            finished[ev.uid] = ev
    want = _jax_tokens(lstm["jmodel"], lstm["jparams"], prompts, [7] * 3,
                       slots=2, max_len=32, chunk=3)
    for uid, w in zip(uids, want):
        np.testing.assert_array_equal(np.asarray(streamed[uid], np.int32), w)
        np.testing.assert_array_equal(finished[uid].tokens, w)
        assert firsts[uid] == 1              # exactly one first=True
    sched2 = ContinuousBatchingEngine(model, params, slots=2, max_len=32,
                                      chunk=3, **CPU)
    uids2 = [sched2.submit(p, 7) for p in prompts]
    got = sched2.run()
    for uid, uid2 in zip(uids, uids2):
        np.testing.assert_array_equal(got[uid2], finished[uid].tokens)


def _deadline_run(make, submit_prompt, clk):
    """The reference test's overload script on one scheduler: a hog
    evicted past its deadline, a request expiring in the queue, a full
    queue shedding the worst. Returns {name: (reason, tokens)}."""
    rng = np.random.default_rng(5)
    sched = make()
    p_hog = rng.integers(0, 32, size=(1, 4))
    p_exp = rng.integers(0, 32, size=(1, 5))
    uids = {"hog": sched.submit(submit_prompt(p_hog), 40, deadline=9.0,
                                priority=1)}
    fin = {f.uid: f for f in sched.step()}
    uids["exp"] = sched.submit(submit_prompt(p_exp), 4, deadline=5.0)
    uids["filler"] = sched.submit(
        submit_prompt(rng.integers(0, 32, size=(1, 3))), 2)
    uids["vip"] = sched.submit(
        submit_prompt(rng.integers(0, 32, size=(1, 3))), 2, priority=1)
    while sched.busy:
        for f in sched.step():
            fin[f.uid] = f
        clk[0] += 2.0
    return {k: (fin[u].reason, np.asarray(fin[u].tokens))
            for k, u in uids.items()}, p_hog


def test_deadlines_expire_evict_and_shed(lstm):
    """Queued requests past deadline expire un-prefilled, an in-slot
    overrun is evicted (its tokens a prefix of the reference), a bounded
    queue sheds the worst request: the reference scheduler's outcomes."""
    model, params = lstm["model"], lstm["params"]
    clk = [0.0]
    got, p_hog = _deadline_run(lambda: ContinuousBatchingEngine(
        model, params, slots=1, max_len=64, chunk=4, clock=lambda: clk[0],
        max_queue=2, **CPU), lambda p: p, clk)
    jclk = [0.0]
    with j_use_backend("ref"):
        want, _ = _deadline_run(lambda: JSched(
            lstm["jmodel"], lstm["jparams"], slots=1, max_len=64, chunk=4,
            clock=lambda: jclk[0], max_queue=2), jnp.asarray, jclk)
    assert got["filler"][0] == "rejected" and not len(got["filler"][1])
    assert got["exp"][0] == "expired" and not len(got["exp"][1])
    assert got["hog"][0] == "expired"
    assert got["vip"][0] == "done" and len(got["vip"][1]) == 2
    n = len(got["hog"][1])
    assert 0 < n < 40
    ref = ServeEngine(model, max_len=64, **CPU).generate(
        params, torch.from_numpy(p_hog), 40)[0].numpy()
    np.testing.assert_array_equal(got["hog"][1], ref[:n])
    for k in got:
        assert got[k][0] == want[k][0], k
        np.testing.assert_array_equal(got[k][1], want[k][1], err_msg=k)


# ------------------------------------------------------------------- fuzz

def _fuzz_round(model, params, cfg, *, seed, slots, chunk, depth, n_req,
                prefill_batch=1):
    """Random arrival interleave + ragged lengths through a small pool;
    returns ([(prompt, budget)], [tokens]) in submission order."""
    rng = np.random.default_rng(seed)
    sched = ContinuousBatchingEngine(
        model, params, slots=slots, max_len=48, chunk=chunk,
        dispatch_depth=depth, prefill_batch=prefill_batch,
        clock=lambda: 0.0, **CPU)
    reqs, fin, uids = [], {}, []
    while len(reqs) < n_req or sched.busy:
        for _ in range(int(rng.integers(0, 3))):
            if len(reqs) >= n_req:
                break
            prompt = rng.integers(0, cfg.vocab_size, size=(
                1, int(rng.integers(2, 12)))).astype(np.int32)
            budget = int(rng.integers(1, 9))
            uids.append(sched.submit(prompt, budget))
            reqs.append((prompt, budget))
        for f in sched.step():
            fin[f.uid] = f
    assert all(fin[u].reason == "done" for u in uids)
    return reqs, [fin[u].tokens for u in uids]


def _fuzz_against_reference(lstm, model, params, jmodel, jparams, rounds,
                            prefill_batch=1):
    """Every (seed, slots, chunk, depth) round's tokens equal the JAX
    scheduler's on the same requests, and the port's batch=1 decode."""
    eng = ServeEngine(model, max_len=48, **CPU)
    for seed, slots, chunk, depth in rounds:
        reqs, got = _fuzz_round(model, params, lstm["cfg"], seed=seed,
                                slots=slots, chunk=chunk, depth=depth,
                                n_req=8, prefill_batch=prefill_batch)
        if depth == rounds[0][3]:
            want = _jax_tokens(jmodel, jparams, [p for p, _ in reqs],
                               [b for _, b in reqs], slots=slots,
                               max_len=48, chunk=chunk, dispatch_depth=depth,
                               prefill_batch=prefill_batch)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        for (prompt, budget), g in zip(reqs, got):
            np.testing.assert_array_equal(g, eng.generate(
                params, torch.from_numpy(prompt), budget)[0].numpy(),
                err_msg=f"seed {seed} slots {slots} chunk {chunk} depth "
                        f"{depth}")


def test_scheduler_fuzz_dense(lstm):
    """Random arrivals, ragged prompts, tiny pools (forced queueing and
    slot reuse), dispatch depths 1-3."""
    _fuzz_against_reference(lstm, lstm["model"], lstm["params"],
                            lstm["jmodel"], lstm["jparams"],
                            [(0, 2, 4, 2), (1, 3, 5, 1), (2, 2, 3, 3)])


@pytest.mark.parametrize("variant", ["packed", "delta0", "int8"])
def test_scheduler_fuzz_packed_delta_quant(lstm, variant):
    """Packed BRDS, Θ=0 temporal delta and calibrated int8 params under the
    dispatch-ahead fuzz (two requests a prefill)."""
    rules = {"packed": {}, "delta0": {"delta": DeltaGateConfig()},
             "int8": {"quant": QuantConfig("int8")}}[variant]
    model, params, jmodel, jparams = _packed(lstm, **rules)
    _fuzz_against_reference(lstm, model, params, jmodel, jparams,
                            [(3 + len(variant), 2, 4, 2)], prefill_batch=2)


# ------------------------------------------------------------ serve_trace

def test_serve_trace_closed_loop_deterministic(lstm):
    """Closed-loop trace serving: every request completes, runs repeat,
    the summary counts add up, and each request's token count is the
    reference scheduler's."""
    model, params = lstm["model"], lstm["params"]
    lc = LoadConfig(rate=100.0, num_requests=9, prompt_short=(2, 5),
                    prompt_long=(6, 10), output_lens=(2, 6), seed=11)
    trace = poisson_trace(lc)
    prompts = make_prompts(trace, lstm["cfg"].vocab_size, seed=11)
    outs = []
    for _ in range(2):
        sched = ContinuousBatchingEngine(model, params, slots=3, max_len=32,
                                         chunk=4, **CPU)
        recs, s = serve_trace(sched, trace, prompts, realtime=False,
                              offered_rps=lc.rate)
        assert s["requests"] == 9 and s["completed"] == 9
        assert s["expired"] == 0 and s["rejected"] == 0
        assert s["tokens"] == sum(r.tokens for r in recs)
        assert s["offered_rps"] == 100.0
        for r in recs:
            assert r.first_token is not None and r.finished is not None
            assert r.ttft >= 0
        outs.append([(r.uid, r.tokens, r.reason) for r in recs])
    assert outs[0] == outs[1]
    with j_use_backend("ref"):
        jrecs, _ = jtraffic.serve_trace(
            JSched(lstm["jmodel"], lstm["jparams"], slots=3, max_len=32,
                   chunk=4), jtraffic.poisson_trace(jtraffic.LoadConfig(
                       rate=100.0, num_requests=9, prompt_short=(2, 5),
                       prompt_long=(6, 10), output_lens=(2, 6), seed=11)),
            prompts, realtime=False)
    assert outs[0] == [(r.uid, r.tokens, r.reason) for r in jrecs]

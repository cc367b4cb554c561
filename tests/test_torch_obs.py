"""The port's ``obs``: the span tracer (a copy of the reference's) and the
on-device counters the scheduler's captured chunk updates in place, on the
CPU, against the reference on the same weights (the counterparts of
``tests/test_obs.py``'s tracer and counter tests).

The load-bearing invariants: the disabled tracer hands back one shared
no-op span; counters harvested at the scheduler's own syncs equal the
offline reductions on the drained cache (fired gauges = the delta cache's
``nx`` / ``nh`` sums, spec counters = ``spec_stats()``) and the reference
scheduler's counters; counters on or off, the tokens are the same."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import LSTMConfig as JConfig, LSTMModel as JModel
from repro.obs import counters as JC
from repro.serving import ContinuousBatchingEngine as JSched
from repro.serving import SamplingConfig as JSampling
from repro.serving import ServeEngine as JEngine
from repro.spec import DraftModel as JDraft
from repro.sparse import DeltaGateConfig as JDelta
from repro.sparse import lstm_policy as jlstm_policy
from repro.sparse import use_backend as j_use_backend
from repro_torch.models import LSTMConfig, LSTMModel, params_from_numpy
from repro_torch.obs import counters as C
from repro_torch.obs import trace as T
from repro_torch.serving import SamplingConfig, ServeEngine
from repro_torch.serving.scheduler import ContinuousBatchingEngine
from repro_torch.sparse import DeltaGateConfig, lstm_policy, occupancy_report
from repro_torch.spec import DraftModel

KW = dict(input_size=16, hidden=32, num_layers=2, vocab_size=48)
GREEDY = SamplingConfig(eos_id=-1)
CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def net():
    jmodel = JModel(JConfig("t", **KW))
    jparams = jmodel.init(jax.random.key(0))
    return dict(jmodel=jmodel, jparams=jparams,
                model=LSTMModel(LSTMConfig("t", **KW)),
                params=params_from_numpy(jax.tree.map(np.asarray, jparams),
                                         "cpu"), prep={})


def _prep(net, theta):
    """Delta-gated packed LSTM serving variant in both packages:
    (port model, params, reference model, params)."""
    if theta not in net["prep"]:
        eng = ServeEngine(net["model"], max_len=32, **CPU, sparsity=(
            lstm_policy(0.5, 0.5, delta=DeltaGateConfig(theta, theta))))
        jeng = JEngine(net["jmodel"], net["jmodel"].cfg, max_len=32, batch=3,
                       sparsity=jlstm_policy(0.5, 0.5, backend="ref",
                                             delta=JDelta(theta, theta)))
        packed, _ = eng.prepare(net["params"])
        jpacked, _ = jeng.prepare(net["jparams"])
        net["prep"][theta] = (eng.model, packed, jeng.model, jpacked)
    return net["prep"][theta]


def _prompts(lens):
    return [np.asarray(jax.random.randint(
        jax.random.fold_in(jax.random.key(1), i), (1, n), 0,
        KW["vocab_size"])) for i, n in enumerate(lens)]


def _serve(model, params, lens, gen=8, jax_side=False, **kw):
    """Serve ``lens``-long prompts; (results by submission, scheduler)."""
    prompts = _prompts(lens)
    if jax_side:
        with j_use_backend("ref"):
            sched = JSched(model, params, max_len=32, chunk=4,
                           sampling=JSampling(eos_id=-1), **kw)
            uids = [sched.submit(jnp.asarray(p), gen) for p in prompts]
            res = sched.run()
    else:
        sched = ContinuousBatchingEngine(model, params, max_len=32, chunk=4,
                                         sampling=GREEDY, **kw, **CPU)
        uids = [sched.submit(p, gen) for p in prompts]
        res = sched.run()
    return [np.asarray(res[u]) for u in uids], sched


# ----------------------------------------------------------------- tracer

def test_disabled_tracer_is_one_shared_null_span():
    T.disable()
    T.get_tracer().clear()      # events an earlier test left
    s1, s2 = T.span("a"), T.span("b", cat="x", k=3)
    assert s1 is s2                     # no per-call allocation
    with s1:
        pass
    assert T.get_tracer().events == []


def test_tracer_spans_nest_and_export_validates(tmp_path):
    T.enable()
    try:
        with T.span("outer", phase="p"):
            with T.span("inner"):
                pass
        T.instant("mark", note=1)

        @T.traced("decorated")
        def f(x):
            return x + 1

        assert f(1) == 2
    finally:
        T.disable()
    payload = T.get_tracer().export()
    assert T.validate(payload) == []
    evs = {e["name"]: e for e in payload["traceEvents"]}
    assert set(evs) == {"outer", "inner", "mark", "decorated"}
    assert evs["inner"]["ts"] >= evs["outer"]["ts"]
    assert (evs["inner"]["ts"] + evs["inner"]["dur"]
            <= evs["outer"]["ts"] + evs["outer"]["dur"] + 1e-6)
    assert evs["outer"]["args"] == {"phase": "p"}
    ts = [e["ts"] for e in payload["traceEvents"]]
    assert ts == sorted(ts)
    path = tmp_path / "trace.json"
    T.get_tracer().save(str(path))
    assert T.validate_file(str(path)) == []
    assert T.main([str(path)]) == 0
    T.get_tracer().clear()


def test_trace_validator_catches_malformed(tmp_path):
    ev = dict(name="a", ph="X", ts=1.0, dur=1.0, pid=1, tid=1)
    assert T.validate([ev]) == []
    assert T.validate({"traceEvents": "nope"})
    assert T.validate([dict(ev, ph="Q")])            # unknown phase
    assert T.validate([dict(ev, dur=-2.0)])          # negative dur
    assert T.validate([{k: v for k, v in ev.items() if k != "ts"}])
    assert T.validate([dict(ev, ts=5.0), dict(ev, ts=1.0)])  # unsorted
    b = dict(name="a", ph="B", ts=1.0, pid=1, tid=1)
    e = dict(name="a", ph="E", ts=2.0, pid=1, tid=1)
    assert T.validate([b, e]) == []
    assert T.validate([b]) and T.validate([e])
    empty = tmp_path / "empty.json"
    empty.write_text('{"traceEvents": []}')
    assert T.main([str(empty)]) != 0
    assert T.main([str(tmp_path / "missing.json")]) != 0


def test_serving_spans_engine_spec_and_scheduler(net):
    """The engine's prepare / prefill / decode_loop / spec_loop spans, the
    spec round's propose / verify / rollback (once a round on the CPU,
    where the body runs eagerly), the scheduler's admit / dispatch /
    harvest, all nested in a valid export."""
    prompt = torch.from_numpy(_prompts([6])[0])
    T.enable()
    try:
        eng = ServeEngine(net["model"], max_len=32, **CPU,
                          sparsity=lstm_policy(0.5, 0.5))
        packed, _ = eng.prepare(net["params"])
        eng.generate(packed, prompt, 4)
        eng.generate(packed, prompt, 4, draft=DraftModel(eng.model, packed),
                     spec_k=2)
        _serve(eng.model, packed, [5, 7], gen=3, slots=2)
    finally:
        T.disable()
    payload = T.get_tracer().export()
    assert T.validate(payload) == []
    names = [e["name"] for e in payload["traceEvents"]]
    for n in ("engine.prepare", "engine.prefill", "engine.decode_loop",
              "engine.spec_loop", "spec.propose", "spec.verify",
              "spec.rollback", "sched.admit", "sched.dispatch",
              "sched.harvest"):
        assert n in names, n
    spans = {e["name"]: e for e in payload["traceEvents"]}
    outer, inner = spans["engine.spec_loop"], spans["spec.verify"]
    assert outer["ts"] <= inner["ts"] <= outer["ts"] + outer["dur"]
    T.get_tracer().clear()


# ----------------------------------------------------- on-device counters

def test_counter_names_and_layout(net):
    model = LSTMModel(LSTMConfig("t", **KW))
    assert C.counter_names(model) == C.BASE_COUNTERS == JC.BASE_COUNTERS
    dmodel, _, jdmodel, _ = _prep(net, 0.1)
    names = C.counter_names(dmodel)
    assert names == JC.counter_names(jdmodel)
    assert names[len(C.BASE_COUNTERS):] == ("fired_x_l0", "fired_h_l0",
                                            "fired_x_l1", "fired_h_l1")
    vec = C.zeros(names)
    assert vec.shape == (len(names),) and vec.dtype == torch.float32
    d = C.harvest(names, vec)
    assert set(d) == set(names) and all(v == 0.0 for v in d.values())
    assert C.fired_totals(d) == ([0.0, 0.0], [0.0, 0.0])


def test_chunk_update_adds_in_place():
    names = C.BASE_COUNTERS
    vec = C.zeros(names)
    st = {"emitted": torch.tensor([2, 0, 3], dtype=torch.int32),
          "rounds": torch.tensor([1, 0, 2], dtype=torch.int32)}
    out = C.chunk_update(names, vec, st, 4)
    C.chunk_update(names, vec, st, 4)
    assert out is vec
    assert C.harvest(names, vec) == {"decode_steps": 8.0, "tokens": 10.0,
                                     "spec_rounds": 6.0, "spec_drafted": 0.0,
                                     "spec_accepted": 0.0}


@pytest.mark.parametrize("theta", [0.0, 0.1])
def test_scheduler_counters_match_occupancy_report(net, theta):
    """Counters harvested at the scheduler's own syncs == the offline
    reductions on the drained cache, exactly, and the reference
    scheduler's counters."""
    model, packed, jmodel, jpacked = _prep(net, theta)
    results, sched = _serve(model, packed, [5, 7, 9], slots=3,
                            counters=True)
    c = sched.counters()
    for i, lp in enumerate(sched.cache["layers"]):
        assert c[f"fired_x_l{i}"] == float(lp["nx"].sum())
        assert c[f"fired_h_l{i}"] == float(lp["nh"].sum())
    assert c["tokens"] == sum(len(v) for v in results)
    assert c["decode_steps"] == sched.steps_dispatched * sched.chunk
    occ = occupancy_report(sched.cache, steps=sched.slot_steps,
                           packed=packed)
    fx, fh = C.fired_totals(c)
    step_sum = float(np.sum(sched.slot_steps))
    X, H = KW["input_size"], KW["hidden"]
    assert occ["occupancy_x"] == pytest.approx(sum(fx) / (step_sum
                                                          * (X + H)))
    assert occ["occupancy_h"] == pytest.approx(sum(fh) / (step_sum * 2 * H))
    jresults, jsched = _serve(jmodel, jpacked, [5, 7, 9], slots=3,
                              counters=True, jax_side=True)
    assert c == jsched.counters()
    for a, b in zip(results, jresults):
        np.testing.assert_array_equal(a, b)


def test_counters_do_not_change_tokens(net):
    """Instrumented and uninstrumented schedulers serve identical tokens;
    the uninstrumented one reports no counters."""
    model, packed, _, _ = _prep(net, 0.1)
    outs = [_serve(model, packed, [5, 7, 9], slots=3, counters=flag)[0]
            for flag in (False, True)]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    assert ContinuousBatchingEngine(model, packed, slots=2, max_len=32,
                                    **CPU).counters() is None


def test_spec_counters_match_spec_stats(net):
    """The target drafting for itself: spec counters == spec_stats() ==
    the reference scheduler's."""
    m, p, jm, jp = net["model"], net["params"], net["jmodel"], net["jparams"]
    results, sched = _serve(m, p, [5, 8], slots=2, draft=DraftModel(m, p),
                            spec_k=3, counters=True)
    st, c = sched.spec_stats(), sched.counters()
    assert st["drafted"] > 0
    assert c["spec_rounds"] == st["rounds"]
    assert c["spec_drafted"] == st["drafted"]
    assert c["spec_accepted"] == st["accepted"]
    assert c["tokens"] == sum(len(v) for v in results)
    _, jsched = _serve(jm, jp, [5, 8], slots=2, draft=JDraft(jm, jp),
                       spec_k=3, counters=True, jax_side=True)
    assert st == jsched.spec_stats()
    assert c == jsched.counters()


def test_lockstep_from_state_matches_occupancy_report(net):
    model, packed, jmodel, jpacked = _prep(net, 0.1)
    prompt = np.asarray(jax.random.randint(jax.random.key(2), (3, 6), 0,
                                           KW["vocab_size"]))
    eng = ServeEngine(model, max_len=32, **CPU)
    _, st = eng.generate(packed, torch.from_numpy(prompt), 8,
                         sampling=GREEDY, return_state=True)
    c = C.from_state(model, st, steps=8)
    assert c["tokens"] == float(st["emitted"].sum()) == 24.0
    for i, lp in enumerate(st["cache"]["layers"]):
        assert c[f"fired_x_l{i}"] == float(lp["nx"].sum())
    occ = occupancy_report(st["cache"], steps=6 + 8, packed=packed)
    assert occ["occupancy_x"] == pytest.approx(
        sum(C.fired_totals(c)[0]) / (3 * (6 + 8) * (KW["input_size"]
                                                    + KW["hidden"])))
    with j_use_backend("ref"):
        jeng = JEngine(jmodel, jmodel.cfg, max_len=32, batch=3)
        _, jst = jeng.generate(jpacked, jnp.asarray(prompt), 8,
                               sampling=JSampling(eos_id=-1),
                               rng=jax.random.key(3), return_state=True)
    assert c == JC.from_state(jmodel, jst, steps=8)

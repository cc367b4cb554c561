"""The port's ``ContinuousBatchingEngine`` on the CPU, against the JAX
reference's scheduler on the same weights (the counterparts of
``tests/test_serving.py``'s continuous-batching tests and of
``tests/test_spec.py``'s scheduler test): ragged prompts through shared
slots give every request its lockstep batch=1 tokens and the reference
scheduler's, for the LSTM (dense and packed), the transformer and the
RG-LRU + local-attention hybrid (recurrentgemma-9b's smoke config, its
prompts past the window of 32); budgets cap at the cache; a reused slot
starts fresh; a draft changes no token. Plus the serve CLI's
``--continuous`` and ``--traffic`` runs and the entry point's device
default."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.models import LSTMConfig as JConfig, LSTMModel as JModel
from repro.models import build_model as j_build
from repro.serving import ContinuousBatchingEngine as JSched
from repro.serving import SamplingConfig as JSampling
from repro.spec import DraftModel as JDraft
from repro.sparse import lstm_policy as jlstm_policy
from repro.sparse import use_backend as j_use_backend
from repro_torch.configs import smoke_config
from repro_torch.models import (LSTMConfig, LSTMModel, build_model,
                                params_from_numpy,
                                transformer_params_from_numpy)
from repro_torch.serving import SamplingConfig, ServeEngine
from repro_torch.serving.scheduler import ContinuousBatchingEngine
from repro_torch.sparse import lstm_policy
from repro_torch.spec import DraftModel

CPU = dict(device="cpu")
GREEDY = SamplingConfig(eos_id=-1)
needs_card = pytest.mark.skipif(not torch.cuda.is_available(),
                                reason="needs a CUDA card: the scheduler's "
                                       "chunk is a CUDA graph there")


@pytest.fixture(scope="module")
def lstm():
    kw = dict(input_size=16, hidden=32, num_layers=2, vocab_size=50)
    jmodel = JModel(JConfig("t", **kw))
    jparams = jmodel.init(jax.random.key(0))
    return dict(cfg=LSTMConfig("t", **kw), model=LSTMModel(
        LSTMConfig("t", **kw)), jmodel=jmodel, jparams=jparams,
        params=params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"))


@pytest.fixture(scope="module")
def transformer():
    jcfg, cfg = j_smoke("qwen3-0.6b"), smoke_config("qwen3-0.6b")
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    return dict(cfg=cfg, model=build_model(cfg), jmodel=jmodel,
                jparams=jparams, params=transformer_params_from_numpy(
                    cfg, jax.tree.map(np.asarray, jparams), "cpu"))


@pytest.fixture(scope="module")
def hybrid():
    name = "recurrentgemma-9b"
    jcfg, cfg = j_smoke(name), smoke_config(name)
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    return dict(cfg=cfg, model=build_model(cfg), jmodel=jmodel,
                jparams=jparams, params=transformer_params_from_numpy(
                    cfg, jax.tree.map(np.asarray, jparams), "cpu"))


# the hybrid's float32 logits, port vs reference (tests/test_torch_
# recurrent.py): its requests' greedy tokens are compared where every
# step's top-2 margin is at least 10x that
HYBRID_ATOL = 1e-3


def _packed_both(lstm):
    plan = jlstm_policy(0.6, 0.4, backend="ref").compile(lstm["jparams"])
    jpacked, _ = plan.pack(*plan.prune(lstm["jparams"]))
    tplan = lstm_policy(0.6, 0.4).compile(lstm["params"])
    packed, _ = tplan.pack(*tplan.prune(lstm["params"]))
    return jpacked, packed


def _run_both(net, params, jparams, prompts, budgets, *, jdraft=None,
              draft=None, **kw):
    """Every request through the port's scheduler and the reference's:
    ({i: port tokens}, {i: reference tokens}, port scheduler)."""
    sched = ContinuousBatchingEngine(net["model"], params, draft=draft,
                                     **kw, **CPU)
    uids = [sched.submit(p, b) for p, b in zip(prompts, budgets)]
    got = sched.run()
    with j_use_backend("ref"):
        jsched = JSched(net["jmodel"], jparams, draft=jdraft, **kw)
        juids = [jsched.submit(jnp.asarray(p), b)
                 for p, b in zip(prompts, budgets)]
        want = jsched.run()
    return ({i: got[u] for i, u in enumerate(uids)},
            {i: np.asarray(want[u]) for i, u in enumerate(juids)}, sched)


@pytest.mark.parametrize("family", ["lstm", "transformer", "hybrid"])
def test_continuous_batching_matches_lockstep(family, request):
    """Ragged prompts through 2 shared slots: each request's lockstep
    batch=1 tokens and the reference scheduler's; slots admit from the
    queue and evict on completion. The hybrid's prompts run past its
    window (32), so its local attention and RG-LRU state both carry."""
    net = request.getfixturevalue(family)
    if family == "hybrid":      # many tiny ops: faster on one thread
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        request.addfinalizer(lambda: torch.set_num_threads(threads))
    vocab = net["cfg"].vocab_size
    rng = np.random.default_rng(30 if family == "hybrid" else 10)
    shapes = [(5, 6), (9, 3), (3, 7), (7, 5)]
    if family == "hybrid":
        shapes = [(37, 6), (9, 3), (40, 7), (7, 5)]
    prompts = [rng.integers(0, vocab, (1, n)) for n, _ in shapes]
    budgets = [g for _, g in shapes]
    max_len = 48 if family == "hybrid" else 24
    sched = ContinuousBatchingEngine(net["model"], net["params"], slots=2,
                                     max_len=max_len, chunk=4, **CPU)
    uids = [sched.submit(p, g) for p, g in zip(prompts, budgets)]
    assert sched.pending == 4           # nothing admitted before step()
    fin = sched.step()                  # admits 2, decodes one chunk
    assert sched.pending == 2
    assert len(sched.active_slots) + len(fin) == 2
    results = {f.uid: f.tokens for f in fin}
    results.update(sched.run())
    assert sched.pending == 0 and not sched.active_slots
    eng = ServeEngine(net["model"], max_len=max_len, **CPU)
    with j_use_backend("ref"):
        jsched = JSched(net["jmodel"], net["jparams"], slots=2,
                        max_len=max_len, chunk=4)
        juids = [jsched.submit(jnp.asarray(p), g)
                 for p, g in zip(prompts, budgets)]
        want = jsched.run()
    for uid, juid, p, g in zip(uids, juids, prompts, budgets):
        if family == "hybrid":
            seq = torch.from_numpy(np.concatenate([p[0], results[uid]]))
            top2 = net["model"].forward(net["params"], seq[None].long())[0][
                0, p.shape[1] - 1:-1, :vocab].topk(2).values
            assert float((top2[:, 0] - top2[:, 1]).min()) > 10 * HYBRID_ATOL
        np.testing.assert_array_equal(results[uid], np.asarray(want[juid]))
        np.testing.assert_array_equal(
            results[uid], eng.generate(net["params"], torch.from_numpy(p),
                                       g)[0].numpy())


def test_scheduler_budget_and_capacity(lstm):
    """Budgets are capped by cache capacity; oversize prompts are
    rejected."""
    sched = ContinuousBatchingEngine(lstm["model"], lstm["params"], slots=1,
                                     max_len=12, chunk=4, **CPU)
    with pytest.raises(ValueError):
        sched.submit(np.zeros((1, 12), np.int32), 4)
    prompt = np.random.default_rng(0).integers(0, 50, (1, 8))
    uid = sched.submit(prompt, 100)
    results = sched.run()
    assert len(results[uid]) == 4           # 12 - 8 capacity, not 100
    with j_use_backend("ref"):
        js = JSched(lstm["jmodel"], lstm["jparams"], slots=1, max_len=12,
                    chunk=4)
        ju = js.submit(jnp.asarray(prompt), 100)
        np.testing.assert_array_equal(results[uid], np.asarray(js.run()[ju]))


def test_packed_continuous_batching(lstm):
    """The scheduler serves SparsityPlan.pack'd LSTM params: the reference
    scheduler's tokens and each request's batch=1 decode."""
    jpacked, packed = _packed_both(lstm)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 50, (1, 3 + i)) for i in range(3)]
    got, want, _ = _run_both(lstm, packed, jpacked, prompts, [4] * 3,
                             slots=2, max_len=16, chunk=4)
    eng = ServeEngine(lstm["model"], max_len=16, **CPU)
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(got[i], want[i])
        np.testing.assert_array_equal(got[i], eng.generate(
            packed, torch.from_numpy(p), 4)[0].numpy())


def test_slot_reuse_resets_position_and_eos(lstm):
    """Evict-then-readmit into the SAME slot: the readmitted request starts
    from its own prompt's position with fresh EOS state. The EOS is A's
    second greedy token where it first occurs there, so A stops
    mid-chunk after two tokens."""
    model, params = lstm["model"], lstm["params"]
    eng = ServeEngine(model, max_len=24, **CPU)
    rng = np.random.default_rng(20)
    for _ in range(20):                 # a prompt whose first two differ
        p_a = rng.integers(0, 50, (1, 5))
        greedy_a = eng.generate(params, torch.from_numpy(p_a), 8)[0]
        if int(greedy_a[0]) != int(greedy_a[1]):
            break
    eos = int(greedy_a[1])
    assert int(greedy_a[0]) != eos
    p_b = rng.integers(0, 50, (1, 9))
    sampling = SamplingConfig(eos_id=eos)
    sched = ContinuousBatchingEngine(model, params, slots=1, max_len=24,
                                     chunk=4, sampling=sampling, **CPU)
    uid_a = sched.submit(p_a, 8)
    uid_b = sched.submit(p_b, 6)
    fin = sched.step()                      # A admitted alone (1 slot)
    assert [f.uid for f in fin] == [uid_a]  # EOS inside the first chunk
    assert sched._slot_uid[0] is None       # slot 0 evicted...
    results = {fin[0].uid: fin[0].tokens}
    results.update(sched.run())             # ...and reused by B
    want_b = eng.generate(params, torch.from_numpy(p_b), 6,
                          sampling=sampling)[0].numpy()
    np.testing.assert_array_equal(results[uid_b], want_b)
    assert list(results[uid_a]) == [int(greedy_a[0]), eos]
    assert sched.slot_steps[0] >= p_b.shape[1]  # restarted at B's join
    with j_use_backend("ref"):
        js = JSched(lstm["jmodel"], lstm["jparams"], slots=1, max_len=24,
                    chunk=4, sampling=JSampling(eos_id=eos))
        ja, jb = js.submit(jnp.asarray(p_a), 8), js.submit(
            jnp.asarray(p_b), 6)
        jres = js.run()
    np.testing.assert_array_equal(results[uid_a], np.asarray(jres[ja]))
    np.testing.assert_array_equal(results[uid_b], np.asarray(jres[jb]))


def test_greedy_spec_lossless_through_scheduler(lstm):
    """Per-slot draft state, chunked rounds, joins and evictions: token
    streams bitwise the draft-free scheduler's and the reference's."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 50, (n,)).astype(np.int32)
               for n in (5, 3, 9, 6, 4)]
    jpacked, packed = _packed_both(lstm)
    kw = dict(slots=3, max_len=32, chunk=4, spec_k=3)
    base, jbase, bsched = _run_both(lstm, lstm["params"], lstm["jparams"],
                                    prompts, [10] * 5, **kw)
    spec, jspec, ssched = _run_both(
        lstm, lstm["params"], lstm["jparams"], prompts, [10] * 5,
        jdraft=JDraft(lstm["jmodel"], jpacked),
        draft=DraftModel(lstm["model"], packed), **kw)
    assert bsched.spec_stats() is None
    for i in base:
        np.testing.assert_array_equal(base[i], spec[i])
        np.testing.assert_array_equal(base[i], jbase[i])
        np.testing.assert_array_equal(spec[i], jspec[i])
    stats = ssched.spec_stats()
    assert stats["drafted"] > 0 and stats["rounds"] > 0
    assert 0.0 <= stats["acceptance_rate"] <= 1.0


def test_scheduler_entry_point_and_mesh(lstm):
    """The device defaults to the card (raising without one), and under a
    mesh packed params that were not partitioned are refused by name
    (sharded serving itself: ``tests/test_torch_dist.py``)."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ContinuousBatchingEngine(lstm["model"], lstm["params"])
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty((1, 2)))
    packed, _ = ServeEngine(lstm["model"], sparsity=lstm_policy(0.75, 0.5),
                            **CPU).prepare(lstm["params"])
    with pytest.raises(ValueError, match="not dist-partitioned"):
        ContinuousBatchingEngine(lstm["model"], packed, mesh=mesh, **CPU)
    with pytest.raises(TypeError):
        ContinuousBatchingEngine(object(), lstm["params"], **CPU)


@pytest.fixture
def _one_thread():
    """The CLI runs many tiny ops: beside other busy processes torch's
    intra-op threads only contend (measured 27.2 s on 8 threads against
    1.6 s on one, six busy processes beside it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.usefixtures("_one_thread")
@pytest.mark.parametrize("argv", [
    ["--continuous", "--slots", "3", "--batch", "5"],
    ["--continuous", "--slots", "2", "--batch", "3", "--draft", "lstm_ptb",
     "--draft-brds", "--spec-k", "2"],
    ["--traffic", "--rate", "200", "--requests", "10", "--slots", "4",
     "--dispatch-depth", "1", "--load-seed", "3", "--deadline", "30"],
])
def test_cli_scheduled_runs(argv, capsys, tmp_path):
    from repro_torch.launch import serve
    trace = tmp_path / "trace.json"
    serve.main(["--arch", "lstm_ptb",
                "--smoke", "--brds", "--device", "cpu", "--gen", "6",
                "--prompt-len", "12", "--trace", str(trace), *argv])
    out = capsys.readouterr().out
    if "--traffic" in argv:
        assert "completed=10 expired=0 rejected=0" in out
        assert "TTFT ms: p50=" in out and "TPOT ms: p50=" in out
    else:
        assert "ragged requests" in out
    if "--draft" in argv:
        assert "spec: acceptance=" in out
    from repro_torch.obs import trace as T
    assert T.validate_file(str(trace)) == []
    T.disable()


@pytest.mark.usefixtures("_one_thread")
@pytest.mark.parametrize("mode", [["--continuous", "--batch", "3"],
                                  ["--traffic", "--requests", "6"]])
def test_cli_scheduled_builds_one_scheduler(mode, capsys, monkeypatch):
    """The warm-up, the measured run and the profiled one share one
    scheduler (its chunk captured once); the chunk count printed is the
    measured run's alone."""
    from repro_torch.launch import serve
    built = []
    real = serve._scheduler

    def scheduler(*a, **kw):
        built.append(real(*a, **kw))
        return built[-1]

    monkeypatch.setattr(serve, "_scheduler", scheduler)
    serve.main(["--arch", "lstm_ptb",
                "--smoke", "--brds", "--device", "cpu", "--gen", "6",
                "--prompt-len", "12", "--slots", "2", "--rate", "500",
                "--profile", *mode])
    out = capsys.readouterr().out
    assert len(built) == 1
    n = int(out.split(" chunk dispatches")[0].rsplit(" ", 1)[1])
    assert 0 < n < built[0].steps_dispatched
    assert "profile: wall" in out


def test_cli_flag_defaults_match_reference():
    """The scheduler flags parse with the reference's defaults."""
    from repro_torch.launch import serve
    args = serve.parser().parse_args([])
    assert (args.arch, args.continuous, args.traffic, args.slots, args.rate,
            args.requests, args.deadline, args.dispatch_depth,
            args.load_seed, args.trace, args.spec_k) == \
        ("qwen3-0.6b", False, False, 4, 8.0, 64, None, 2, 0, None, 4)


@needs_card
def test_scheduler_on_card_matches_cpu(lstm):
    """On the card every chunk is a replayed CUDA graph: the same tokens
    as the CPU's eager chunks, at dispatch depths 1 and 2."""
    params = params_from_numpy(jax.tree.map(np.asarray, lstm["jparams"]),
                               "cuda")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 50, (1, n)) for n in (3, 9, 5, 7, 4)]
    outs = []
    for dev, depth in (("cpu", 1), ("cuda", 1), ("cuda", 2)):
        sched = ContinuousBatchingEngine(
            lstm["model"], lstm["params"] if dev == "cpu" else params,
            slots=2, max_len=24, chunk=4, dispatch_depth=depth, device=dev)
        uids = [sched.submit(p, 6) for p in prompts]
        got = sched.run()
        outs.append([got[u] for u in uids])
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            np.testing.assert_array_equal(a, b)

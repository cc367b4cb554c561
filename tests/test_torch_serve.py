"""The port's main path as a whole on the CPU: a 2-layer BRDS-LSTM
(X=64, H=96, V=97) pruned and packed by ``lstm_policy(0.75, 0.5)`` and
served through ``ServeEngine``, against the JAX reference's engine on the
same weights; plus sampling, the decode loop's stops, the CLI and the
device default of the entry points."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import LSTMConfig as JConfig, LSTMModel as JModel
from repro.serving import ServeEngine as JEngine
from repro.serving import SamplingConfig as JSampling
from repro.serving.sampling import _filtered as j_filtered
from repro.sparse import lstm_policy as jlstm_policy
from repro_torch.device import resolve_device
from repro_torch.models import LSTMConfig, LSTMModel, params_from_numpy
from repro_torch.serving import SamplingConfig, ServeEngine, sample, \
    sample_dist
from repro_torch.serving.sampling import _filtered
from repro_torch.sparse import lstm_policy

LOGIT_ATOL = 1e-5   # float32 sums in another order, through 2 layers
MARGIN = 1e-4       # 10x the logits' tolerance: greedy parity holds above it
MAX_LEN = 40


@pytest.fixture(scope="module")
def served():
    """The same weights prepared by both engines."""
    kw = dict(input_size=64, hidden=96, num_layers=2, vocab_size=97)
    jcfg, cfg = JConfig("t", **kw), LSTMConfig("t", **kw)
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jeng = JEngine(jmodel, jcfg, max_len=MAX_LEN, batch=3,
                   sparsity=jlstm_policy(0.75, 0.5))
    eng = ServeEngine(LSTMModel(cfg), max_len=MAX_LEN,
                      sparsity=lstm_policy(0.75, 0.5), device="cpu")
    jpacked, jrep = jeng.prepare(jparams)
    packed, rep = eng.prepare(params)
    prompt = np.random.default_rng(10).integers(0, 97, (3, 8))
    return dict(jeng=jeng, eng=eng, jpacked=jpacked, packed=packed,
                jrep=jrep, rep=rep, prompt=prompt, cfg=cfg)


def _teacher_forced(model, params, seq):
    cache = model.init_cache(seq.shape[0], seq.shape[1], "cpu")
    out = []
    for t in range(seq.shape[1] - 1):
        logits, cache = model.decode_step(params, cache, seq[:, t:t + 1], t)
        out.append(logits[:, 0])
    return torch.stack(out, 1)


def _margins(logits):
    top2 = logits.topk(2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def test_prepare_matches_jax(served):
    assert served["rep"] == served["jrep"]
    jl, tl = served["jpacked"]["layers"], served["packed"]["layers"]
    for jlayer, tlayer in zip(jl, tl):
        for key in ("w_x", "w_h"):
            j, t = jlayer[key], tlayer[key]
            np.testing.assert_array_equal(t.values.numpy(),
                                          np.asarray(j.values))
            np.testing.assert_array_equal(t.deltas.numpy(),
                                          np.asarray(j.deltas))
            assert (t.ncols, t.pad, t.block_rows) == \
                (j.ncols, j.pad, j.block_rows)
        # H=96 → 384 gate rows padded to the 256-row block: 512
        assert tlayer["w_x"].values.shape[0] == 512
        assert tlayer["w_x"].deltas.dtype == torch.int8
    for key in ("embed", "head"):
        for name, leaf in served["packed"][key].items():
            np.testing.assert_array_equal(
                leaf.numpy(), np.asarray(served["jpacked"][key][name]))


@pytest.mark.parametrize("ragged", [False, True])
def test_prefill_logits_match_jax(served, ragged):
    prompt = served["prompt"]
    length = np.array([8, 5, 3]) if ragged else None
    jl, jcache = served["jeng"].model.prefill(
        served["jpacked"], jnp.asarray(prompt), MAX_LEN,
        length=None if length is None else jnp.asarray(length))
    tl, tcache = served["eng"].model.prefill(
        served["packed"], torch.as_tensor(prompt), MAX_LEN,
        length=None if length is None else torch.as_tensor(length))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=LOGIT_ATOL)
    for jlayer, tlayer in zip(jcache["layers"], tcache["layers"]):
        for k in ("c", "h"):
            np.testing.assert_allclose(tlayer[k].numpy(),
                                       np.asarray(jlayer[k]), rtol=0,
                                       atol=LOGIT_ATOL)


def test_greedy_generate_matches_jax(served):
    """Greedy tokens are identical, at a seed whose per-step argmax margin
    is asserted to be far above the logits' tolerance."""
    prompt, steps = served["prompt"], 12
    want = np.asarray(served["jeng"].generate(served["jpacked"],
                                              jnp.asarray(prompt), steps))
    got = served["eng"].generate(served["packed"], torch.as_tensor(prompt),
                                 steps)
    seq = torch.cat([torch.as_tensor(prompt), got.long()], 1)
    logits = _teacher_forced(served["eng"].model, served["packed"], seq)
    assert float(_margins(logits[:, prompt.shape[1] - 1:]).min()) > MARGIN
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32


def test_ragged_generate_matches_jax(served):
    """A right-padded batch with per-row lengths generates what the
    reference generates, and each row what its unpadded prompt gives."""
    prompt, steps = served["prompt"], 8
    lengths = np.array([8, 5, 3])
    want = np.asarray(served["jeng"].generate(
        served["jpacked"], jnp.asarray(prompt), steps,
        lengths=jnp.asarray(lengths)))
    got = served["eng"].generate(served["packed"], torch.as_tensor(prompt),
                                 steps, lengths=torch.as_tensor(lengths))
    np.testing.assert_array_equal(got.numpy(), want)
    for i, n in enumerate(lengths):
        alone = served["eng"].generate(
            served["packed"], torch.as_tensor(prompt[i:i + 1, :n]), steps)
        np.testing.assert_array_equal(alone.numpy()[0], got.numpy()[i])


def test_eos_and_pad_match_jax(served):
    """Per-sequence EOS stops: the EOS token is emitted, then pad ids."""
    prompt, steps = served["prompt"], 10
    free = served["eng"].generate(served["packed"], torch.as_tensor(prompt),
                                  steps).numpy()
    eos = int(free[0, 3])
    want = np.asarray(served["jeng"].generate(served["jpacked"],
                                              jnp.asarray(prompt), steps,
                                              eos_id=eos))
    got = served["eng"].generate(served["packed"], torch.as_tensor(prompt),
                                 steps, eos_id=eos).numpy()
    np.testing.assert_array_equal(got, want)
    stop = list(free[0]).index(eos)
    assert (got[0, stop + 1:] == 0).all() and got[0, stop] == eos


def test_decode_loop_budget_and_done_match_jax(served):
    """Per-sequence budgets and sequences that start finished: the same
    tokens, pad ids, emitted counts and positions as the reference loop."""
    from repro.serving import decode_loop as j_decode_loop
    from repro_torch.serving import decode_loop
    prompt, steps = served["prompt"], 7
    budget, done = np.array([2, 5, 9]), np.array([False, True, False])
    jl, jc = served["jeng"].model.prefill(served["jpacked"],
                                          jnp.asarray(prompt), MAX_LEN)
    jt, js = j_decode_loop(served["jeng"].model, served["jpacked"], jc, jl,
                           jnp.full((3,), 8, jnp.int32), jax.random.key(0),
                           steps, JSampling(), done=jnp.asarray(done),
                           budget=jnp.asarray(budget), limit=MAX_LEN)
    tl, tc = served["eng"].model.prefill(served["packed"],
                                         torch.as_tensor(prompt), MAX_LEN)
    tt, ts = decode_loop(served["eng"].model, served["packed"], tc, tl,
                         torch.full((3,), 8), None, steps, SamplingConfig(),
                         done=torch.as_tensor(done),
                         budget=torch.as_tensor(budget), limit=MAX_LEN)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    for k in ("emitted", "pos", "done"):
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))


def test_model_pack_matches_jax(served):
    """``LSTMModel.pack``: from the prune masks, and re-selecting the
    survivors by magnitude when no masks are given."""
    jmodel, model = served["jeng"].model, served["eng"].model
    jparams = jmodel.init(jax.random.key(2))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jpruned, jmasks = jmodel.prune(jparams, 0.75, 0.5)
    pruned, masks = model.prune(params, 0.75, 0.5)
    for m in (masks, None):
        got = model.pack(pruned, m)
        want = jmodel.pack(jpruned, None if m is None else jmasks)
        for jl, tl in zip(want, got):
            for key in ("sx", "sh"):
                np.testing.assert_array_equal(tl[key].values.numpy(),
                                              np.asarray(jl[key].values))
                np.testing.assert_array_equal(tl[key].deltas.numpy(),
                                              np.asarray(jl[key].deltas))
                assert tl[key].pad == jl[key].pad


def test_fused_and_chained_serving_bitwise(served):
    """The port's chained path (``fused=False``) reproduces the default
    fused trajectory bit for bit, tokens and final cache."""
    prompt = torch.as_tensor(served["prompt"])
    outs = {}
    for fused in (True, False):
        eng = ServeEngine(LSTMModel(served["cfg"], fused=fused),
                          max_len=MAX_LEN, device="cpu")
        outs[fused] = eng.generate(served["packed"], prompt, 6,
                                   return_state=True)
    (ta, sa), (tb, sb) = outs[True], outs[False]
    assert torch.equal(ta, tb)
    for la, lb in zip(sa["cache"]["layers"], sb["cache"]["layers"]):
        assert torch.equal(la["c"], lb["c"]) and torch.equal(la["h"], lb["h"])


def test_score_matches_jax(served):
    seq = np.random.default_rng(8).integers(0, 97, (2, 10))
    want = float(served["jeng"].model.score(served["jpacked"],
                                            jnp.asarray(seq)))
    got = float(served["eng"].model.score(served["packed"],
                                          torch.as_tensor(seq)))
    assert abs(got - want) < LOGIT_ATOL


def test_dense_serving_matches_jax(served):
    """Dense params step through the plain matmul path."""
    jparams = served["jeng"].model.init(jax.random.key(1))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    prompt = served["prompt"][:2, :5]
    jl, _ = served["jeng"].model.prefill(jparams, jnp.asarray(prompt),
                                         MAX_LEN)
    tl, _ = served["eng"].model.prefill(params, torch.as_tensor(prompt),
                                        MAX_LEN)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=LOGIT_ATOL)


# ---------------------------------------------------------------- sampling

@pytest.mark.parametrize("cfg", [
    dict(temperature=0.7), dict(temperature=1.0, top_k=5),
    dict(temperature=1.3, top_p=0.8), dict(temperature=0.9, top_k=20,
                                           top_p=0.5)])
def test_filtered_matches_jax(cfg):
    """The top-k / top-p masks are the reference's; kept logits agree."""
    logits = np.random.default_rng(5).normal(size=(4, 97)).astype(np.float32)
    want = np.asarray(j_filtered(jnp.asarray(logits), JSampling(**cfg)))
    got = _filtered(torch.from_numpy(logits), SamplingConfig(**cfg)).numpy()
    np.testing.assert_array_equal(got <= -1e29, want <= -1e29)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cfg", [dict(temperature=1.0),
                                 dict(temperature=0.8, top_k=3),
                                 dict(temperature=1.0, top_p=0.7)])
def test_sample_draws_from_sample_dist(cfg):
    """Draws follow ``sample_dist``: frequencies within 4 standard errors
    over 20000 draws, and never outside the filtered support."""
    cfg = SamplingConfig(**cfg)
    logits = torch.tensor([[2.0, 1.5, 1.0, 0.3, 0.0, -1.0]])
    p = sample_dist(logits, cfg)[0]
    n = 20000
    gen = torch.Generator().manual_seed(0)
    draws = sample(gen, logits.expand(n, -1), cfg).long()
    freq = torch.bincount(draws, minlength=p.numel()).float() / n
    se = (p * (1 - p) / n).sqrt()
    assert bool(((freq - p).abs() <= 4 * se + 1e-9).all()), (freq, p)
    assert bool((freq[p == 0] == 0).all())


def test_greedy_sample_and_dist():
    logits = torch.tensor([[0.1, 3.0, 3.0, -2.0], [5.0, 0.0, 1.0, 2.0]])
    cfg = SamplingConfig()
    assert sample(None, logits, cfg).tolist() == [1, 0]
    assert sample_dist(logits, cfg).tolist() == [[0, 1, 0, 0], [1, 0, 0, 0]]
    with pytest.raises(ValueError):
        SamplingConfig(top_p=-0.1)


# ----------------------------------------------------- entry points, CLI

def test_entry_points_default_to_the_card():
    """Without a card the default device raises instead of running on the
    CPU; ``device="cpu"`` is the explicit way there."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    cfg = LSTMConfig("t", input_size=8, hidden=8, vocab_size=11)
    model = LSTMModel(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init()
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(model)
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "lstm_ptb", "--smoke"])
    assert model.init(device="cpu")["embed"]["table"].device.type == "cpu"


def test_unported_model_options_raise():
    """Sharded decode is ported (``tests/test_torch_dist.py``): ``mesh=``
    turns the fused path off, and a meshed model refuses dense params.
    Fused delta + quant is ported (kernel B9): every way of building it
    constructs a fused model, and it serves the same tokens and cache as
    the chained path."""
    import types
    from repro_torch.quant import QuantConfig, default_plan
    from repro_torch.sparse import DeltaGateConfig
    cfg = LSTMConfig("t", input_size=8, hidden=8, vocab_size=11)
    plan, delta = default_plan(QuantConfig("int8"), 1), DeltaGateConfig()
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(1, 2))
    meshed = LSTMModel(cfg, delta=delta, mesh=mesh)
    assert meshed.mesh is mesh and not meshed._use_fused
    assert meshed.with_quant(plan).mesh is mesh
    assert meshed.with_mesh(None)._use_fused
    with pytest.raises(ValueError, match="partitioned packed params"):
        meshed.prefill(meshed.init(device="cpu"), torch.tensor([[1, 2]]), 8)
    for model in (LSTMModel(cfg, delta=delta, quant=plan),
                  LSTMModel(cfg, quant=plan).with_delta(delta),
                  LSTMModel(cfg, fused=False, delta=delta,
                            quant=plan).with_fused(True)):
        assert model.fused and model.delta == delta and model.quant == plan
    for kw in (dict(delta=delta), dict(quant=plan),
               dict(delta=delta, quant=plan, fused=False)):
        LSTMModel(cfg, **kw)
    eng = ServeEngine(LSTMModel(cfg), device="cpu",
                      sparsity=lstm_policy(0.5, 0.5, delta=delta,
                                           quant=QuantConfig("int8")))
    params = eng.model.init(device="cpu")
    packed, report = eng.prepare(params)
    assert eng.model.fused and report["sparsity"] > 0
    prompt = torch.tensor([[1, 2, 3], [4, 5, 6]])
    fused = eng.generate(packed, prompt, 4, return_state=True)
    chained = ServeEngine(eng.model.with_fused(False), device="cpu").generate(
        packed, prompt, 4, return_state=True)
    assert torch.equal(fused[0], chained[0])
    for la, lb in zip(fused[1]["cache"]["layers"],
                      chained[1]["cache"]["layers"]):
        assert all(torch.equal(la[k], lb[k]) for k in la)


def test_serve_cli_delta_quant_fused_needs_the_card_by_default():
    """Delta + quant runs fused by default; without ``--device cpu`` and
    with no card the CLI raises rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "lstm_ptb",
                    "--smoke", "--brds", "--delta", "0", "--quant", "int8"])


def test_serve_cli_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "lstm_ptb",
                "--smoke", "--brds", "--device", "cpu", "--batch", "2",
                "--prompt-len", "4", "--gen", "3"])
    out = capsys.readouterr().out
    assert "arch=lstm_ptb" in out and "tok/s" in out and "BRDS:" in out
    serve.main(["--arch", "lstm_ptb",
                "--smoke", "--brds", "--no-fused", "--device", "cpu",
                "--batch", "1", "--prompt-len", "3", "--gen", "2",
                "--temperature", "0.8", "--top-k", "5", "--profile"])
    out = capsys.readouterr().out
    assert "generated (1, 2)" in out and "median of 5 runs" in out
    assert "profile: wall" in out


@pytest.mark.parametrize("extra,expect", [
    (["--delta", "0"], "delta: occupancy x="),
    (["--delta", "0.05", "--delta-h", "0.02", "--occupancy", "0.5",
      "--no-fused"], "effective-ops reduction"),
    (["--quant", "int8"], "packed_bytes"),
    (["--quant", "q1.11", "--delta", "0", "--no-fused"], "delta: occupancy"),
    (["--quant", "int8", "--delta", "0"], "delta: occupancy"),
])
def test_serve_cli_delta_and_quant_on_cpu(capsys, extra, expect):
    from repro_torch.launch import serve
    serve.main(["--arch", "lstm_ptb",
                "--smoke", "--brds", "--device", "cpu", "--batch", "2",
                "--prompt-len", "4", "--gen", "3", *extra])
    out = capsys.readouterr().out
    assert "generated (2, 3)" in out and expect in out


@pytest.mark.parametrize("argv", [["--quant", "int8"],
                                  ["--brds", "--delta-h", "0.1"],
                                  ["--brds", "--occupancy", "0.5"]])
def test_serve_cli_rejects_bad_flag_combinations(argv):
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.main(["--arch", "lstm_ptb", "--smoke", "--device", "cpu", *argv])


def test_full_width_config_shapes():
    """lstm_ptb at its published width packs to the shapes the kernels are
    timed at: 6000 gate rows padded to 6144, Kx=375, Kh=750, int16."""
    from repro_torch.core import keep_count
    from repro_torch.core.packing import _delta_dtype
    from repro_torch.models import LSTM_CONFIGS
    cfg = LSTM_CONFIGS["lstm_ptb"]
    assert dataclasses.astuple(cfg)[1:5] == (1500, 1500, 1, 10000)
    assert keep_count(cfg.input_size, 0.75) == 375
    assert keep_count(cfg.hidden, 0.5) == 750
    assert _delta_dtype(cfg.hidden, 750) == torch.int16
    assert 4 * cfg.hidden + (-4 * cfg.hidden) % 256 == 6144


@pytest.mark.parametrize("flags,fused", [([], True), (["--fused"], True),
                                         (["--no-fused"], False),
                                         (["--no-fused", "--fused"], True)])
def test_serve_cli_fused_flag_reaches_the_model(monkeypatch, capsys, flags,
                                                fused):
    """``--fused`` parses, as the reference's ``launch.serve`` has it, and
    it and ``--no-fused`` reach ``LSTMModel(fused=...)``; fused is the
    default."""
    import repro_torch.models as tmodels
    from repro_torch.launch import serve
    seen = []

    class Recording(tmodels.LSTMModel):
        def __init__(self, cfg, **kw):
            seen.append(kw.get("fused"))
            super().__init__(cfg, **kw)

    monkeypatch.setattr(tmodels, "LSTMModel", Recording)
    serve.main(["--arch", "lstm_ptb",
                "--smoke", "--brds", "--device", "cpu", "--batch", "1",
                "--prompt-len", "3", "--gen", "2", *flags])
    assert seen == [fused]
    assert "generated (1, 2)" in capsys.readouterr().out


def test_device_span_counts_overlapping_kernels_once():
    """The profile's device span is the union of the device events'
    intervals: a programmatic dependent that starts (and waits) while its
    producer runs adds only what lies past the producer's end; host
    events and user annotations add nothing."""
    from types import SimpleNamespace as NS
    from repro_torch.launch.serve import _device_span
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(start, end, dev=cuda, note=False):
        return NS(time_range=NS(start=start, end=end), device_type=dev,
                  is_user_annotation=note)

    events = [ev(0, 36), ev(30, 40), ev(50, 55), ev(52, 53), ev(0, 100, cpu),
              ev(0, 100, note=True)]
    assert _device_span(events) == pytest.approx(45e-6)
    assert _device_span([]) == 0.0

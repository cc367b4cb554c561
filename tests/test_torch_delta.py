"""The port's temporal-delta path on the CPU against the JAX reference:
thresholding (Θ = 0, Θ > 0, capped, ties at the cap), occupancy, the plain
delta kernels, and a 2-layer BRDS-LSTM (X=64, H=96, V=97) served through
``ServeEngine`` with ``lstm_policy(0.75, 0.5, delta=...)`` on the same
weights. Inputs come from numpy with a seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import LSTMConfig as JConfig, LSTMModel as JModel
from repro.serving import ServeEngine as JEngine
from repro.sparse import DeltaGateConfig as JDelta
from repro.sparse import lstm_policy as jlstm_policy
from repro.sparse import temporal as jtemporal
from repro.sparse import use_backend as juse_backend
from repro_torch.kernels import ops
from repro_torch.models import LSTMConfig, LSTMModel, params_from_numpy
from repro_torch.serving import ServeEngine
from repro_torch.sparse import DeltaGateConfig, lstm_policy
from repro_torch.sparse import temporal

from test_torch_kernels import _arr, _case, _close

KERNEL_ATOL = 2e-5  # the reference's own delta-kernel tolerance
LOGIT_ATOL = 1e-4   # float32 sums in another order, m carried over steps
MARGIN = 1e-4
MAX_LEN = 40
THETAS = (0.0, 0.05)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------------------ thresholding

def _tied(rng, shape):
    """Values on a 0.5 grid: many equal |delta| at any cap boundary."""
    return (np.round(rng.normal(size=shape) * 2) / 2).astype(np.float32)


@pytest.mark.parametrize("theta,cap,tied", [
    (0.0, None, False), (0.3, None, False), (0.0, 0.25, False),
    (0.1, 0.3, False), (0.0, 0.25, True), (0.5, 0.1, True)])
def test_delta_threshold_matches_jax(theta, cap, tied):
    """Deltas, fired masks and references are equal to the reference's; a
    capped row keeps the reference's columns when |d| ties at the cap."""
    rng = np.random.default_rng(1)
    mk = _tied if tied else (lambda r, s: _arr(r, *s))
    v, ref = mk(rng, (5, 60)), mk(rng, (5, 60))
    want = jtemporal.delta_threshold(jnp.asarray(v), jnp.asarray(ref), theta,
                                     cap)
    got = temporal.delta_threshold(_t(v), _t(ref), theta, cap)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if theta == 0.0 and cap is None:
        assert torch.equal(got[2], _t(v))   # Θ = 0 tracks v bit for bit
    if cap is not None:
        assert int(got[1].sum(1).max()) <= temporal.cap_count(cap, 60)


def test_cap_count_and_config_validation_match_jax():
    for cap in (None, 0.001, 0.25, 0.5, 0.999, 1.0):
        for n in (1, 7, 128, 1500):
            assert temporal.cap_count(cap, n) == jtemporal.cap_count(cap, n)
    for kw in (dict(theta_x=-0.1), dict(theta_h=-1.0), dict(cap_x=0.0),
               dict(cap_h=1.5)):
        with pytest.raises(ValueError):
            JDelta(**kw)
        with pytest.raises(ValueError):
            DeltaGateConfig(**kw)
    assert DeltaGateConfig(0.1, 0.2, 0.5) == DeltaGateConfig(
        theta_x=0.1, theta_h=0.2, cap_x=0.5)


# ------------------------------------------------------- plain delta ops

def _delta_case(seed, B, X, H):
    j, t = _case(seed, B, X, H)
    rng = np.random.default_rng(seed + 100)
    arrs = dict(dx=_arr(rng, B, X), dh=_arr(rng, B, H),
                fx=(rng.random((B, X)) < 0.5).astype(np.float32),
                fh=(rng.random((B, H)) < 0.5).astype(np.float32),
                m=_arr(rng, B, 4 * H))
    j.update({k: jnp.asarray(v) for k, v in arrs.items()})
    t.update({k: _t(v) for k, v in arrs.items()})
    return j, t


@pytest.mark.parametrize("jbackend", ["pallas", "ref"])
@pytest.mark.parametrize("pwl", [False, True])
def test_delta_plain_versions_match_jax(jbackend, pwl):
    """m' of the delta dual-SpMV, and (c, h, m') of the chained and fused
    delta steps, within the reference's delta-kernel tolerance."""
    j, t = _delta_case(5, 3, 100, 96)
    jargs = [j[k] for k in ("sx", "dx", "fx", "sh", "dh", "fh", "m")]
    targs = [t[k] for k in ("sx", "dx", "fx", "sh", "dh", "fh", "m")]
    _close(ops.delta_rb_dual_spmv(*targs),
           jops.delta_rb_dual_spmv(*jargs, backend=jbackend), KERNEL_ATOL)
    for jstep, tstep in ((jops.brds_delta_lstm_step, ops.brds_delta_lstm_step),
                         (jops.fused_brds_delta_lstm_step,
                          ops.fused_brds_delta_lstm_step)):
        want = jstep(*jargs, j["b"], j["c"], pwl=pwl, backend=jbackend)
        got = tstep(*targs, t["b"], t["c"], pwl=pwl)
        for g, w in zip(got, want):
            _close(g, w, KERNEL_ATOL)


@pytest.mark.parametrize("jbackend", ["pallas", "ref"])
@pytest.mark.parametrize("mask", ["float", "bool"])
def test_delta_rb_spmv_matches_jax(jbackend, mask):
    """The single-family delta SpMV on both families, the fired mask given
    as 0/1 floats or as bool (cast to float32 first, as the reference
    casts it); an all-zero mask gives an exact 0."""
    j, t = _delta_case(7, 3, 100, 96)
    for fam, d, f in (("sx", "dx", "fx"), ("sh", "dh", "fh")):
        jf, tf = j[f], t[f]
        if mask == "bool":
            jf, tf = jf.astype(bool), tf.bool()
        want = jops.delta_rb_spmv(j[fam], j[d], jf, backend=jbackend)
        got = ops.delta_rb_spmv(t[fam], t[d], tf)
        assert got.shape == (3, 4 * 96)
        _close(got, want, KERNEL_ATOL)
        zero = ops.delta_rb_spmv(t[fam], t[d], torch.zeros_like(tf))
        assert not zero.any()


@pytest.mark.parametrize("pwl", [False, True])
def test_delta_fused_bitwise_vs_chained(pwl):
    _, t = _delta_case(6, 3, 72, 40)
    args = [t[k] for k in ("sx", "dx", "fx", "sh", "dh", "fh", "m", "b",
                           "c")]
    for a, b in zip(ops.fused_brds_delta_lstm_step(*args, pwl=pwl),
                    ops.brds_delta_lstm_step(*args, pwl=pwl)):
        assert torch.equal(a, b)
    # an unfired column contributes nothing: all-zero masks leave m as is
    zero = [torch.zeros_like(t["fx"]), torch.zeros_like(t["fh"])]
    m = ops.delta_rb_dual_spmv(t["sx"], t["dx"], zero[0], t["sh"], t["dh"],
                               zero[1], t["m"])
    assert torch.equal(m, t["m"])


# ------------------------------------------------------- model + engine

KW = dict(input_size=64, hidden=96, num_layers=2, vocab_size=97)


@pytest.fixture(scope="module")
def base():
    jmodel = JModel(JConfig("t", **KW))
    jparams = jmodel.init(jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    prompt = np.random.default_rng(10).integers(0, 97, (3, 8))
    return dict(jmodel=jmodel, jparams=jparams, params=params,
                prompt=prompt, cfg=LSTMConfig("t", **KW))


def _engines(base, theta, fused=True):
    d = dict(theta_x=theta, theta_h=theta)
    jeng = JEngine(base["jmodel"], base["jmodel"].cfg, max_len=MAX_LEN,
                   batch=3, sparsity=jlstm_policy(0.75, 0.5,
                                                  delta=JDelta(**d)))
    eng = ServeEngine(LSTMModel(base["cfg"], fused=fused), max_len=MAX_LEN,
                      sparsity=lstm_policy(0.75, 0.5,
                                           delta=DeltaGateConfig(**d)),
                      device="cpu")
    jpacked, jrep = jeng.prepare(base["jparams"])
    packed, rep = eng.prepare(base["params"])
    return jeng, eng, jpacked, packed, jrep, rep


@pytest.fixture(scope="module", params=THETAS, ids=lambda t: f"theta{t}")
def served(base, request):
    jeng, eng, jpacked, packed, jrep, rep = _engines(base, request.param)
    return dict(base, theta=request.param, jeng=jeng, eng=eng,
                jpacked=jpacked, packed=packed, jrep=jrep, rep=rep)


def test_prepare_with_delta_matches_jax(served):
    """prepare wires the rule into the model and packs what the
    reference packs; the report is the reference's."""
    assert served["rep"] == served["jrep"]
    assert served["eng"].model.delta == DeltaGateConfig(served["theta"],
                                                        served["theta"])
    for jl, tl in zip(served["jpacked"]["layers"],
                      served["packed"]["layers"]):
        for key in ("w_x", "w_h"):
            np.testing.assert_array_equal(tl[key].values.numpy(),
                                          np.asarray(jl[key].values))
            np.testing.assert_array_equal(tl[key].deltas.numpy(),
                                          np.asarray(jl[key].deltas))


@pytest.mark.parametrize("ragged", [False, True])
def test_delta_prefill_matches_jax(served, ragged):
    """Logits and every cache leaf (c, h, refs, m, counters) after a
    length-masked prefill."""
    prompt = served["prompt"]
    length = np.array([8, 5, 3]) if ragged else None
    with juse_backend("ref"):
        jl, jcache = served["jeng"].model.prefill(
            served["jpacked"], jnp.asarray(prompt), MAX_LEN,
            length=None if length is None else jnp.asarray(length))
    tl, tcache = served["eng"].model.prefill(
        served["packed"], _t(prompt), MAX_LEN,
        length=None if length is None else _t(length))
    _close(tl, jl, LOGIT_ATOL)
    for jlayer, tlayer in zip(jcache["layers"], tcache["layers"]):
        assert sorted(tlayer) == sorted(jlayer)
        for k in tlayer:
            _close(tlayer[k], jlayer[k], LOGIT_ATOL)
    if ragged:   # frozen past each length: the counters stop too
        n = tcache["layers"][0]["nx"].numpy()
        assert n[0] > n[1] > n[2]


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


def test_delta_greedy_matches_jax(served):
    """Greedy tokens are the reference's, at a seed whose per-step top-2
    margin is asserted to be far above the logits' tolerance."""
    prompt, steps = served["prompt"], 10
    with juse_backend("ref"):
        want = np.asarray(served["jeng"].generate(
            served["jpacked"], jnp.asarray(prompt), steps))
    got = served["eng"].generate(served["packed"], _t(prompt), steps)
    seq = torch.cat([_t(prompt), got.long()], 1)
    logits = _teacher_forced(served["eng"].model, served["packed"], seq)
    assert float(_margins(logits[:, prompt.shape[1] - 1:]).min()) > MARGIN
    np.testing.assert_array_equal(got.numpy(), want)


def test_delta_fused_and_chained_serving_bitwise(served):
    """The chained delta path reproduces the fused one bit for bit: tokens
    and the whole final cache."""
    prompt = _t(served["prompt"])
    outs = {}
    for fused in (True, False):
        model = served["eng"].model.with_fused(fused)
        eng = ServeEngine(model, max_len=MAX_LEN, device="cpu")
        outs[fused] = eng.generate(served["packed"], prompt, 6,
                                   return_state=True)
    (ta, sa), (tb, sb) = outs[True], outs[False]
    assert torch.equal(ta, tb)
    for la, lb in zip(sa["cache"]["layers"], sb["cache"]["layers"]):
        for k in la:
            assert torch.equal(la[k], lb[k]), k


def test_delta_theta0_tokens_equal_packed_float(base):
    """Θ = 0 reproduces packed decode up to re-association: the same greedy
    tokens as the port's packed float path, above a checked margin."""
    _, deng, _, dpacked, _, _ = _engines(base, 0.0)
    feng = ServeEngine(LSTMModel(base["cfg"]), max_len=MAX_LEN,
                       sparsity=lstm_policy(0.75, 0.5), device="cpu")
    fpacked, _ = feng.prepare(base["params"])
    prompt = _t(base["prompt"])
    want = feng.generate(fpacked, prompt, 10)
    got = deng.generate(dpacked, prompt, 10)
    seq = torch.cat([prompt, want.long()], 1)
    logits = _teacher_forced(feng.model, fpacked, seq)
    assert float(_margins(logits[:, prompt.shape[1] - 1:]).min()) > MARGIN
    assert torch.equal(got, want)


def test_occupancy_report_matches_jax(served):
    """The report over a served cache, lockstep and per-sequence steps."""
    prompt, steps = served["prompt"], 6
    with juse_backend("ref"):
        _, jstate = served["jeng"].generate(
            served["jpacked"], jnp.asarray(prompt), steps, return_state=True)
    _, tstate = served["eng"].generate(served["packed"], _t(prompt), steps,
                                       return_state=True)
    for st in (8 + steps, np.array([14, 10, 7])):
        want = jtemporal.occupancy_report(jstate["cache"], steps=st,
                                          packed=served["jpacked"])
        got = temporal.occupancy_report(tstate["cache"], steps=st,
                                        packed=served["packed"])
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k] == pytest.approx(float(want[k]), rel=1e-6), k
    if served["theta"] == 0.0:
        assert got["occupancy_x"] > 0.5


def test_dense_delta_serving_matches_jax(base):
    """``--delta`` without ``--brds``: a ratio-0 policy leaves the weights
    dense and the dense masked-delta step runs."""
    d = DeltaGateConfig(0.05, 0.05)
    jeng = JEngine(base["jmodel"], base["jmodel"].cfg, max_len=MAX_LEN,
                   batch=3, sparsity=jlstm_policy(0.0, 0.0,
                                                  delta=JDelta(0.05, 0.05)))
    eng = ServeEngine(LSTMModel(base["cfg"]), max_len=MAX_LEN,
                      sparsity=lstm_policy(0.0, 0.0, delta=d), device="cpu")
    jparams, _ = jeng.prepare(base["jparams"])
    params, _ = eng.prepare(base["params"])
    assert not eng.model.is_packed(params)
    prompt = base["prompt"][:2, :6]
    jl, _ = jeng.model.prefill(jparams, jnp.asarray(prompt), MAX_LEN)
    tl, _ = eng.model.prefill(params, _t(prompt), MAX_LEN)
    _close(tl, jl, LOGIT_ATOL)
    seq = base["prompt"][:2]
    assert float(eng.model.score(params, _t(seq))) == pytest.approx(
        float(jeng.model.score(jparams, jnp.asarray(seq))), abs=LOGIT_ATOL)

"""The port's quantized path on the CPU against the JAX reference: schemes,
codes and scales (equal, not close), calibration, the int32 wrap warning,
the q8 plain kernels on the same codes (equal), quantized packing, and a
2-layer BRDS-LSTM (X=64, H=96, V=97) served through ``ServeEngine`` with
``lstm_policy(0.75, 0.5, quant=...)``, both packages fed the same
``QuantPlan`` scales. Inputs come from numpy with a seed."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.packing import pack_from_dense, pad_packed
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import LSTMConfig as JConfig, LSTMModel as JModel
from repro.quant import QuantConfig as JQuantConfig
from repro.quant import calibrate as jcal
from repro.quant import formats as jqf
from repro.quant import scheme as jqs
from repro.serving import ServeEngine as JEngine
from repro.sparse import DeltaGateConfig as JDelta
from repro.sparse import get_format as jget_format
from repro.sparse import lstm_policy as jlstm_policy
from repro.sparse import use_backend as juse_backend
from repro_torch.core import packing as tpack
from repro_torch.kernels import ops, ref
from repro_torch.models import (LSTMConfig, LSTMModel, packed_from_numpy,
                                packed_q8_from_numpy, params_from_numpy,
                                quant_plan_from_scales)
from repro_torch.quant import (QuantConfig, QuantPlan, calibrate, formats,
                               scheme as tqs)
from repro_torch.serving import ServeEngine
from repro_torch.sparse import DeltaGateConfig, get_format, lstm_policy

from test_torch_kernels import _arr, _close

SCHEMES = ("int8", "q1.11")
LOGIT_ATOL = 1e-4   # float cell and head in other orders; codes may differ
MARGIN = 1e-4       # only where float rounding crosses a rounding boundary
MAX_LEN = 40


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.numpy().dtype == np.asarray(want).dtype


def _q8_from_jax(q):
    return packed_q8_from_numpy(q.values, q.deltas, q.scales, q.ncols,
                                q.qmax, q.frac_bits, q.pad, q.block_rows)


# ----------------------------------------------------------------- scheme

@pytest.mark.parametrize("spec", ["int8", "q1.11", "q0.11", "q3.4",
                                  "q0.15"])
def test_parse_scheme_matches_jax(spec):
    j, t = jqs.parse_scheme(spec), tqs.parse_scheme(spec)
    assert (t.name, t.qmax, t.frac_bits, t.fixed_scale, t.bits) == \
        (j.name, j.qmax, j.frac_bits, j.fixed_scale, j.bits)
    assert t.storage.itemsize == j.storage.itemsize
    assert t.act_scale(0.5) == j.act_scale(0.5)
    assert tqs.parse_scheme(t) is t


@pytest.mark.parametrize("spec", ["int4", "q1.15", "q2.0", "fp8"])
def test_bad_schemes_raise_like_jax(spec):
    with pytest.raises(ValueError):
        jqs.parse_scheme(spec)
    with pytest.raises(ValueError):
        tqs.parse_scheme(spec)
    with pytest.raises(ValueError):
        QuantConfig(spec)


@pytest.mark.parametrize("spec", SCHEMES)
def test_quantize_and_row_scales_match_jax(spec):
    """Codes (round half to even, clipped) and per-row scales are equal to
    the reference's, including exact .5 ties and saturation."""
    rng = np.random.default_rng(3)
    w = _arr(rng, 40, 33, scale=3.0)
    w[0, :4] = 0.0
    w[1] = 0.0                                      # an all-zero row
    js, ts = jqs.parse_scheme(spec), tqs.parse_scheme(spec)
    jsc, tsc = jqs.row_scales(jnp.asarray(w), js), tqs.row_scales(_t(w), ts)
    _eq(tsc, jsc)
    _eq(tqs.quantize(_t(w), tsc[:, None], ts),
        jqs.quantize(jnp.asarray(w), jsc[:, None], js))
    x = np.concatenate([_arr(rng, 200) * 40, np.arange(-6, 6) + 0.5])
    x = x.astype(np.float32)
    for s in (0.0123, 1 / 127, 2.0 ** -11, 1.0):
        _eq(tqs.quantize(_t(x), s, ts), jqs.quantize(jnp.asarray(x), s, js))
    _close(tqs.dequantize(tqs.quantize(_t(x), 0.5, ts), 0.5),
           jqs.dequantize(jqs.quantize(jnp.asarray(x), 0.5, js), 0.5), 0)


@pytest.mark.parametrize("spec", SCHEMES)
def test_quantize_packed_matches_jax(spec):
    """Codes, scales and deltas of a quantized packing, its padding, its
    dequantized form and its byte accounting."""
    w = _arr(np.random.default_rng(4), 300, 90, scale=0.3)
    js = pack_from_dense(jnp.asarray(w), 0.6)
    ts = packed_from_numpy(js.values, js.deltas, js.ncols)
    jq, tq = jqf.quantize_packed(js, spec), formats.quantize_packed(ts, spec)
    for k in ("values", "deltas", "scales"):
        _eq(getattr(tq, k), getattr(jq, k))
    assert (tq.ncols, tq.qmax, tq.frac_bits, tq.rows, tq.K, tq.scheme.name) \
        == (jq.ncols, jq.qmax, jq.frac_bits, jq.rows, jq.K, jq.scheme.name)
    assert tq.memory_bytes() == jq.memory_bytes()
    jp, tp = pad_packed(jq), tpack.pad_packed(tq)
    for k in ("values", "deltas", "scales"):
        _eq(getattr(tp, k), getattr(jp, k))
    assert (tp.pad, tp.block_rows, tp.rows) == (jp.pad, jp.block_rows,
                                                jp.rows)
    assert tp.memory_bytes() == jp.memory_bytes()
    for a, b in ((tp.logical(), jp.logical()),
                 (formats.dequantize_packed(tp), jqf.dequantize_packed(jp))):
        _eq(a.values, b.values)
    assert formats.packed_bytes_q(300, 90, 0.6, spec) == \
        jqf.packed_bytes_q(300, 90, 0.6, spec)


def test_check_accumulator_warns_where_jax_warns():
    """A wide-K, high-qmax fixed-point packing can wrap the int32
    accumulator: both packages warn; int8 and q1.11 never do here."""
    big = np.full((8, 256), 15.9, np.float32)
    js = pack_from_dense(jnp.asarray(big), 0.5)
    ts = packed_from_numpy(js.values, js.deltas, js.ncols)
    with pytest.warns(UserWarning, match="int32 kernel accumulator"):
        jqf.quantize_packed(js, "q4.11")
    with pytest.warns(UserWarning, match="int32 kernel accumulator"):
        formats.quantize_packed(ts, "q4.11")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for spec in SCHEMES:
            jqf.quantize_packed(js, spec)
            formats.quantize_packed(ts, spec)


def test_registered_q8_format_matches_jax():
    w = _arr(np.random.default_rng(6), 64, 48)
    jfmt, tfmt = jget_format("row_balanced_q8"), get_format("row_balanced_q8")
    jm, tm = jfmt.mask(jnp.asarray(w), 0.75), tfmt.mask(_t(w), 0.75)
    _eq(tm, jm)
    for opts in ({}, {"scheme": "q1.11"}):
        jq, tq = jfmt.pack(jnp.asarray(w), jm, **opts), \
            tfmt.pack(_t(w), tm, **opts)
        for k in ("values", "deltas", "scales"):
            _eq(getattr(tq, k), getattr(jq, k))
        _eq(tfmt.unpack(tq), jfmt.unpack(jq))
        assert tfmt.packed_bytes(64, 48, 0.75, torch.float32, **opts) == \
            jfmt.packed_bytes(64, 48, 0.75, jnp.float32, **opts)
        assert tfmt.memory_bytes(tq) == jfmt.memory_bytes(jq)
        # matvec (B10) and dual_matvec (B7) equal the reference's: the
        # same codes and a dynamic max-abs activation scale each
        x, h = _arr(np.random.default_rng(7), 2, 48), _arr(
            np.random.default_rng(8), 2, 48)
        _eq(tfmt.matvec(tq, _t(x)), jfmt.matvec(jq, jnp.asarray(x)))
        _eq(tfmt.dual_matvec(tq, _t(x), tq, _t(h)),
            jfmt.dual_matvec(jq, jnp.asarray(x), jq, jnp.asarray(h)))


# ------------------------------------------------------- q8 plain kernels

def _q8_case(seed, spec, B=3, X=100, H=96):
    rng = np.random.default_rng(seed)
    jsx = pad_packed(jqf.quantize_packed(pack_from_dense(
        jnp.asarray(_arr(rng, 4 * H, X, scale=X ** -0.5)), 0.75), spec))
    jsh = pad_packed(jqf.quantize_packed(pack_from_dense(
        jnp.asarray(_arr(rng, 4 * H, H, scale=H ** -0.5)), 0.5), spec))
    arrs = dict(x=_arr(rng, B, X), h=np.tanh(_arr(rng, B, H)),
                c=_arr(rng, B, H), b=_arr(rng, 4 * H, scale=0.1),
                m=_arr(rng, B, 4 * H),
                dx=_arr(rng, B, X, scale=0.5), dh=_arr(rng, B, H, scale=0.3),
                fx=rng.random((B, X)) < 0.5, fh=rng.random((B, H)) < 0.5)
    j = dict(sx=jsx, sh=jsh, **{k: jnp.asarray(v) for k, v in arrs.items()})
    t = dict(sx=_q8_from_jax(jsx), sh=_q8_from_jax(jsh),
             **{k: _t(v) for k, v in arrs.items()})
    return j, t


@pytest.mark.parametrize("spec", SCHEMES)
def test_q8_plain_versions_equal_jax(spec):
    """Given the same codes, the q8 plain versions equal the reference's
    exactly: integer sums and one dequant multiply per row."""
    j, t = _q8_case(7, spec)
    js, ts = jqs.parse_scheme(spec), tqs.parse_scheme(spec)
    qx, qh = jqs.quantize(j["x"], 0.02, js), jqs.quantize(j["h"], 0.01, js)
    tqx, tqh = tqs.quantize(t["x"], 0.02, ts), tqs.quantize(t["h"], 0.01, ts)
    _eq(tqx, qx)
    _eq(ref.rb_spmv_q8_ref(t["sx"], tqx, 0.02),
        jref.rb_spmv_q8_ref(j["sx"], qx, 0.02))
    _eq(ref.rb_dual_spmv_q8_ref(t["sx"], tqx, 0.02, t["sh"], tqh, 0.01,
                                t["b"]),
        jref.rb_dual_spmv_q8_ref(j["sx"], qx, 0.02, j["sh"], qh, 0.01,
                                 j["b"]))
    _eq(ref.delta_rb_dual_spmv_q8_ref(t["sx"], tqx, 0.02, t["sh"], tqh,
                                      0.01, t["m"]),
        jref.delta_rb_dual_spmv_q8_ref(j["sx"], qx, 0.02, j["sh"], qh, 0.01,
                                       j["m"]))


@pytest.mark.parametrize("jbackend", ["pallas", "ref"])
@pytest.mark.parametrize("spec", SCHEMES)
@pytest.mark.parametrize("scales", [(None, None), (0.03, 0.008)])
def test_q8_ops_match_jax(jbackend, spec, scales):
    """The q8 wrappers (quantizing inside, dynamic max-abs scales when none
    are given): gate preactivations and m' equal to the reference's, the
    cell's (c, h) within float tolerance."""
    j, t = _q8_case(8, spec)
    kw = dict(act_scale_x=scales[0], act_scale_h=scales[1])
    _eq(ops.rb_dual_spmv_q8(t["sx"], t["x"], t["sh"], t["h"], t["b"], **kw),
        jops.rb_dual_spmv_q8(j["sx"], j["x"], j["sh"], j["h"], j["b"],
                             backend=jbackend, **kw))
    dargs = ("sx", "dx", "fx", "sh", "dh", "fh", "m")
    _eq(ops.delta_rb_dual_spmv_q8(*(t[k] for k in dargs), **kw),
        jops.delta_rb_dual_spmv_q8(*(j[k] for k in dargs), backend=jbackend,
                                   **kw))
    for jstep, tstep in ((jops.brds_lstm_step_q8, ops.brds_lstm_step_q8),
                         (jops.fused_brds_lstm_step_q8,
                          ops.fused_brds_lstm_step_q8)):
        want = jstep(j["sx"], j["x"], j["sh"], j["h"], j["b"], j["c"],
                     backend=jbackend, **kw)
        got = tstep(t["sx"], t["x"], t["sh"], t["h"], t["b"], t["c"], **kw)
        for g, w in zip(got, want):
            _close(g, w, 1e-5)
    want = jops.brds_delta_lstm_step_q8(*(j[k] for k in dargs), j["b"],
                                        j["c"], backend=jbackend, **kw)
    for tstep in (ops.brds_delta_lstm_step_q8,
                  ops.fused_brds_delta_lstm_step_q8):
        got = tstep(*(t[k] for k in dargs), t["b"], t["c"], **kw)
        for g, w in zip(got, want):
            _close(g, w, 1e-5)


@pytest.mark.parametrize("jbackend", ["pallas", "ref"])
@pytest.mark.parametrize("spec", SCHEMES)
@pytest.mark.parametrize("scale", [None, 0.03])
def test_rb_spmv_q8_matches_jax(jbackend, spec, scale):
    """The single-family q8 SpMV on both families equals the reference's:
    the same codes (quantized inside, with a dynamic max-abs scale when
    none is given), integer sums, one dequant multiply per row."""
    j, t = _q8_case(11, spec)
    for fam, act in (("sx", "x"), ("sh", "h")):
        got = ops.rb_spmv_q8(t[fam], t[act], act_scale=scale)
        assert got.shape == (3, 4 * 96)
        _eq(got, jops.rb_spmv_q8(j[fam], j[act], act_scale=scale,
                                 backend=jbackend))


@pytest.mark.parametrize("jbackend", ["pallas", "ref"])
@pytest.mark.parametrize("spec", SCHEMES)
@pytest.mark.parametrize("pwl", [False, True])
def test_fused_delta_q8_step_matches_jax(jbackend, spec, pwl):
    """The fused delta-q8 step on the reference's codes: the codes of the
    masked deltas equal, m' exactly equal, c and h within 1e-6 (the cell's
    exp and tanh in other libraries)."""
    j, t = _q8_case(12, spec)
    kw = dict(act_scale_x=0.05, act_scale_h=None)
    jcodes = []
    for d, f, fam, sc in (("dx", "fx", "sx", 0.05), ("dh", "fh", "sh", None)):
        jm = jnp.where(j[f].astype(bool), j[d], 0).astype(j[d].dtype)
        jcodes += jops._quant_act(jm, j[fam], sc)
    tcodes = ops._masked_codes(t["dx"], t["fx"], t["sx"], 0.05, t["dh"],
                               t["fh"], t["sh"], None)
    for g, w in zip(tcodes[0::2], jcodes[0::2]):
        _eq(g, w)
    for g, w in zip(tcodes[1::2], jcodes[1::2]):   # the activation scales
        assert np.float32(g) == np.float32(w)
    dargs = ("sx", "dx", "fx", "sh", "dh", "fh", "m", "b", "c")
    want = jops.fused_brds_delta_lstm_step_q8(*(j[k] for k in dargs),
                                              pwl=pwl, backend=jbackend, **kw)
    got = ops.fused_brds_delta_lstm_step_q8(*(t[k] for k in dargs), pwl=pwl,
                                            **kw)
    _eq(got[2], want[2])
    for g, w in zip(got[:2], want[:2]):
        _close(g, w, 1e-6)


@pytest.mark.parametrize("spec", SCHEMES)
@pytest.mark.parametrize("pwl", [False, True])
def test_q8_fused_bitwise_vs_chained(spec, pwl):
    _, t = _q8_case(9, spec, B=2, X=72, H=40)
    args = (t["sx"], t["x"], t["sh"], t["h"], t["b"], t["c"])
    for a, b in zip(ops.fused_brds_lstm_step_q8(*args, pwl=pwl),
                    ops.brds_lstm_step_q8(*args, pwl=pwl)):
        assert torch.equal(a, b)
    dargs = [t[k] for k in ("sx", "dx", "fx", "sh", "dh", "fh", "m", "b",
                            "c")]
    for a, b in zip(ops.fused_brds_delta_lstm_step_q8(*dargs, pwl=pwl),
                    ops.brds_delta_lstm_step_q8(*dargs, pwl=pwl)):
        assert torch.equal(a, b)


# ---------------------------------------------------------- calibration

KW = dict(input_size=64, hidden=96, num_layers=2, vocab_size=97)


@pytest.fixture(scope="module")
def base():
    jmodel = JModel(JConfig("t", **KW))
    jparams = jmodel.init(jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(10)
    return dict(jmodel=jmodel, jparams=jparams, params=params,
                prompt=rng.integers(0, 97, (3, 8)),
                calib=rng.integers(0, 97, (3, 12)),
                cfg=LSTMConfig("t", **KW))


@pytest.mark.parametrize("cfg", [dict(scheme="int8"),
                                 dict(scheme="int8", method="percentile",
                                      percentile=90.0),
                                 dict(scheme="q1.11")])
def test_calibrate_lstm_matches_jax(base, cfg):
    want = jcal.calibrate_lstm(base["jmodel"], base["jparams"],
                               jnp.asarray(base["calib"]),
                               JQuantConfig(**cfg))
    got = calibrate.calibrate_lstm(LSTMModel(base["cfg"]), base["params"],
                                   _t(base["calib"]), QuantConfig(**cfg))
    assert got.scheme.name == want.scheme.name and got.num_layers == 2
    np.testing.assert_allclose(np.array(got.act_scales),
                               np.array(want.act_scales), rtol=1e-5)
    for n in (1, 3):
        d, jd = (calibrate.default_plan(QuantConfig(**cfg), n),
                 jcal.default_plan(JQuantConfig(**cfg), n))
        assert d.act_scales == jd.act_scales


# ------------------------------------------------------- model + engine

def _engines(base, spec, delta=False, calib=True, fused=True):
    jd = JDelta() if delta else None
    td = DeltaGateConfig() if delta else None
    jeng = JEngine(base["jmodel"].with_fused(fused),
                   base["jmodel"].cfg, max_len=MAX_LEN, batch=3,
                   sparsity=jlstm_policy(0.75, 0.5, delta=jd,
                                         quant=JQuantConfig(spec)))
    eng = ServeEngine(LSTMModel(base["cfg"], fused=fused),
                      max_len=MAX_LEN,
                      sparsity=lstm_policy(0.75, 0.5, delta=td,
                                           quant=QuantConfig(spec)),
                      device="cpu")
    c = base["calib"] if calib else None
    jpacked, jrep = jeng.prepare(base["jparams"],
                                 calib=None if c is None else jnp.asarray(c))
    packed, rep = eng.prepare(base["params"],
                              calib=None if c is None else _t(c))
    return jeng, eng, jpacked, packed, jrep, rep


MODES = {"int8": ("int8", False, True), "q1.11": ("q1.11", False, True),
         "delta_int8_chained": ("int8", True, False),
         "delta_int8_fused": ("int8", True, True)}


@pytest.fixture(scope="module", params=sorted(MODES))
def served(base, request):
    spec, delta, fused = MODES[request.param]
    jeng, eng, jpacked, packed, jrep, rep = _engines(base, spec, delta,
                                                     fused=fused)
    plan = eng.model.quant
    # both packages serve with the reference's calibrated scales
    eng.model = eng.model.with_quant(quant_plan_from_scales(
        jeng.model.quant.scheme, jeng.model.quant.act_scales))
    return dict(base, mode=request.param, jeng=jeng, eng=eng,
                jpacked=jpacked, packed=packed, jrep=jrep, rep=rep,
                plan=plan)


def test_prepare_with_quant_matches_jax(served):
    """prepare calibrates (within rtol 1e-5 of the reference's scales),
    rewires the model and packs the reference's codes and scales."""
    assert served["rep"] == served["jrep"]
    assert isinstance(served["plan"], QuantPlan)
    np.testing.assert_allclose(np.array(served["plan"].act_scales),
                               np.array(served["jeng"].model.quant.act_scales),
                               rtol=1e-5)
    assert (served["eng"].model.delta is None) == \
        (served["jeng"].model.delta is None)
    for jl, tl in zip(served["jpacked"]["layers"],
                      served["packed"]["layers"]):
        for key in ("w_x", "w_h"):
            assert isinstance(tl[key], formats.RowBalancedSparseQ8)
            for k in ("values", "deltas", "scales"):
                _eq(getattr(tl[key], k), getattr(jl[key], k))
            assert (tl[key].pad, tl[key].block_rows, tl[key].qmax) == \
                (jl[key].pad, jl[key].block_rows, jl[key].qmax)


@pytest.mark.parametrize("ragged", [False, True])
def test_quant_prefill_matches_jax(served, ragged):
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


def _teacher_forced(model, params, seq):
    cache = model.init_cache(seq.shape[0], seq.shape[1], "cpu")
    out = []
    for t in range(seq.shape[1] - 1):
        logits, cache = model.decode_step(params, cache, seq[:, t:t + 1], t)
        out.append(logits[:, 0])
    return torch.stack(out, 1)


def test_quant_greedy_matches_jax(served):
    """Greedy tokens are the reference's at a seed whose per-step top-2
    margin is asserted to be far above the logits' tolerance."""
    prompt, steps = served["prompt"], 10
    with juse_backend("ref"):
        want = np.asarray(served["jeng"].generate(
            served["jpacked"], jnp.asarray(prompt), steps))
    got = served["eng"].generate(served["packed"], _t(prompt), steps)
    seq = torch.cat([_t(prompt), got.long()], 1)
    logits = _teacher_forced(served["eng"].model, served["packed"], seq)
    top2 = logits[:, prompt.shape[1] - 1:].topk(2, dim=-1).values
    assert float((top2[..., 0] - top2[..., 1]).min()) > MARGIN
    np.testing.assert_array_equal(got.numpy(), want)


def test_quant_fused_and_chained_serving_bitwise(base):
    """The port's fused q8 path equals its chained one bit for bit: tokens
    and final cache."""
    _, eng, _, packed, _, _ = _engines(base, "int8")
    prompt = _t(base["prompt"])
    outs = {}
    for fused in (True, False):
        e = ServeEngine(eng.model.with_fused(fused), max_len=MAX_LEN,
                        device="cpu")
        outs[fused] = e.generate(packed, prompt, 6, return_state=True)
    (ta, sa), (tb, sb) = outs[True], outs[False]
    assert torch.equal(ta, tb)
    for la, lb in zip(sa["cache"]["layers"], sb["cache"]["layers"]):
        assert torch.equal(la["c"], lb["c"]) and torch.equal(la["h"], lb["h"])


def test_delta_quant_fused_and_chained_serving_bitwise(base):
    """Temporal delta with int8: the fused path (one kernel per layer-step)
    equals the chained one bit for bit, tokens and every cache leaf."""
    _, eng, _, packed, _, _ = _engines(base, "int8", delta=True)
    assert eng.model.fused and eng.model.delta is not None
    prompt = _t(base["prompt"])
    outs = {}
    for fused in (True, False):
        e = ServeEngine(eng.model.with_fused(fused), max_len=MAX_LEN,
                        device="cpu")
        outs[fused] = e.generate(packed, prompt, 6, return_state=True)
    (ta, sa), (tb, sb) = outs[True], outs[False]
    assert torch.equal(ta, tb)
    for la, lb in zip(sa["cache"]["layers"], sb["cache"]["layers"]):
        assert sorted(la) == sorted(lb)
        for k in la:
            assert torch.equal(la[k], lb[k]), k


def test_uncalibrated_prepare_and_model_pack_match_jax(base):
    """``prepare`` without a calibration batch takes ``default_plan``;
    ``LSTMModel.pack(quant=)`` emits the reference's codes."""
    _, eng, _, _, _, _ = _engines(base, "int8", calib=False)
    assert eng.model.quant.act_scales == ((1 / 127, 1 / 127),) * 2
    jpruned, jmasks = base["jmodel"].prune(base["jparams"], 0.75, 0.5)
    model = LSTMModel(base["cfg"])
    pruned, masks = model.prune(base["params"], 0.75, 0.5)
    for spec in SCHEMES:
        want = base["jmodel"].pack(jpruned, jmasks, quant=spec)
        got = model.pack(pruned, masks, quant=JQuantConfig(spec))
        for jl, tl in zip(want, got):
            for key in ("sx", "sh"):
                for k in ("values", "deltas", "scales"):
                    _eq(getattr(tl[key], k), getattr(jl[key], k))
        assert LSTMModel.is_quantized({"layers": [{"w_x": got[0]["sx"]}]})

"""The dry run's stand-ins against the JAX reference's, and the kernels'
fakes against their plain versions.

* ``abstract_params`` of every zoo config and the paper's LSTMs: the same
  (shape, dtype) multiset as the reference's ``ShapeDtypeStruct``s, whose
  scanned ``blocks`` leaves count once a layer;
* ``abstract_quantize_packed`` and ``row_balanced_q8``'s
  ``abstract_pack`` (the other formats': ``tests/test_torch_formats.py``);
* ``SparsityPlan.pack(abstract=True)`` and ``brds_pack_params(
  abstract=True)`` under ``transformer_policy(0.75, 0.5)`` (float and
  int8) for every zoo config, and ``lstm_policy`` for lstm_ptb: reports
  equal to the reference's as integers, on the port's per-layer tree and
  on the reference's stacked tree (``_Site.L``), whose packed reps match
  the reference's shape for shape;
* ``launch.specs.input_specs`` for every (arch × shape);
* each kernel entry point on fake tensors (``ops.fakes_as_card``): the
  outputs of its plain version's shapes and dtypes, and one fake launch
  counted in ``ops.KERNEL_FLOPS``, no kernel built.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import SHAPES as JSHAPES, get_arch as jget_arch
from repro.launch.specs import input_specs as jinput_specs
from repro.models import LSTMConfig as JConfig, LSTMModel as JModel
from repro.models import build_model as jbuild_model
from repro.quant import QuantConfig as JQuant
from repro.quant import abstract_quantize_packed as jabstract_q
from repro.sparse import get_format as jget_format
from repro.sparse import lstm_policy as jlstm_policy
from repro.sparse import transformer_policy as jtransformer_policy
from repro.training import masked as jmasked
from repro_torch.configs import ARCH_NAMES, SHAPES, get_arch
from repro_torch.core import packing as P
from repro_torch.core import sparsity as S
from repro_torch.kernels import ops
from repro_torch.launch.specs import input_specs
from repro_torch.models import LSTM_CONFIGS, LSTMModel, build_model
from repro_torch.quant import (QuantConfig, abstract_quantize_packed,
                               quantize_packed)
from repro_torch.sparse import get_format, lstm_policy, transformer_policy
from repro_torch.sparse.formats import abstract
from repro_torch.training import masked

STACKED = ("blocks", "enc_blocks", "dec_blocks", "dec")


def _dt(dtype) -> str:
    return (str(dtype).removeprefix("torch.") if isinstance(dtype, torch.dtype)
            else np.dtype(dtype).name)


def _ref_leaves(tree) -> list:
    """(shape, dtype) of each reference leaf, a scanned one (leading layer
    axis under ``STACKED``) once a layer, sorted."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = getattr(path[0], "key", None)
        shape = tuple(leaf.shape)
        n, shape = ((shape[0], shape[1:]) if key in STACKED
                    else (1, shape))
        out += [(shape, _dt(leaf.dtype))] * n
    return sorted(out)


def _port_leaves(tree) -> list:
    from repro_torch.training.tree import leaves
    got = []
    for t in leaves(tree):
        assert t.is_meta
        got.append((tuple(t.shape), _dt(t.dtype)))
    return sorted(got)


@pytest.mark.parametrize("name", ARCH_NAMES + ["lstm_ptb"])
def test_abstract_params_match_reference(name):
    if name in LSTM_CONFIGS:
        cfg = LSTM_CONFIGS[name]
        got = LSTMModel(cfg).abstract_params()
        want = JModel(JConfig(cfg.name, input_size=cfg.input_size,
                              hidden=cfg.hidden,
                              vocab_size=cfg.vocab_size)).abstract_params()
    else:
        got = build_model(get_arch(name)).abstract_params()
        want = jbuild_model(jget_arch(name)).abstract_params()
    assert _port_leaves(got) == _ref_leaves(want)


@pytest.mark.parametrize("scheme", ["int8", "q1.11"])
def test_abstract_quantize_packed_matches_reference(scheme):
    rows, ncols, ratio = 96, 300, 0.75
    rep = get_format("row_balanced").abstract_pack(rows, ncols, ratio,
                                                   torch.float32)
    jrep = jget_format("row_balanced").abstract_pack(rows, ncols, ratio,
                                                     np.float32)
    pairs = [(abstract_quantize_packed(rep, scheme),
              jabstract_q(jrep, scheme)),
             (get_format("row_balanced_q8").abstract_pack(
                 rows, ncols, ratio, torch.float32, scheme=scheme),
              jget_format("row_balanced_q8").abstract_pack(
                  rows, ncols, ratio, np.float32, scheme=scheme))]
    for got, want in pairs:
        for f in ("values", "deltas", "scales"):
            g, w = getattr(got, f), getattr(want, f)
            assert g.is_meta and tuple(g.shape) == tuple(w.shape), f
            assert _dt(g.dtype) == _dt(w.dtype), f
        assert (got.ncols, got.qmax, got.frac_bits) == (
            want.ncols, want.qmax, want.frac_bits)


def _meta_like(tree):
    """The reference's abstract tree as ``meta`` tensors, its paths kept
    (tuples as lists): a stacked tree the port's format API takes."""
    if isinstance(tree, dict):
        return {k: _meta_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_meta_like(v) for v in tree]
    return abstract(tree.shape, getattr(torch, np.dtype(tree.dtype).name))


def _rep_shapes(tree) -> list:
    from repro_torch.sparse.policy import _leaves_with_path
    out = []
    for ps, leaf in _leaves_with_path(tree):
        if not isinstance(leaf, torch.Tensor):
            out += [(ps, f.name, tuple(getattr(leaf, f.name).shape),
                     _dt(getattr(leaf, f.name).dtype))
                    for f in dataclasses.fields(leaf)
                    if isinstance(getattr(leaf, f.name), torch.Tensor)]
    return sorted(out)


def _jrep_shapes(tree) -> list:
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: dataclasses.is_dataclass(x))[0]:
        if dataclasses.is_dataclass(leaf):
            ps = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                          for k in path)
            out += [(ps, f.name, tuple(getattr(leaf, f.name).shape),
                     _dt(getattr(leaf, f.name).dtype))
                    for f in dataclasses.fields(leaf)
                    if hasattr(getattr(leaf, f.name), "shape")]
    return sorted(out)


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_abstract_pack_reports_match_reference(name, quant):
    """The pack report of the port's per-layer tree, of the reference's
    stacked tree through the port, and of brds_pack_params, all equal to
    the reference's; the stacked reps shape for shape the reference's."""
    jpol = jtransformer_policy(0.75, 0.5)
    pol = transformer_policy(0.75, 0.5)
    if quant:
        jpol, pol = jpol.with_quant(JQuant(quant)), pol.with_quant(
            QuantConfig(quant))
    jabs = jbuild_model(jget_arch(name)).abstract_params()
    jpacked, want = jpol.compile(jabs).pack(jabs, abstract=True)
    tabs = build_model(get_arch(name)).abstract_params()
    _, got = pol.compile(tabs).pack(tabs, abstract=True)
    stacked = _meta_like(jabs)
    plan = pol.compile(stacked)
    assert any(site.L for site in plan.sites.values())
    spacked, got_stacked = plan.pack(stacked, abstract=True)
    assert got == got_stacked == want
    assert _rep_shapes(spacked) == _jrep_shapes(jpacked)
    if quant is None:
        with pytest.warns(DeprecationWarning):
            _, shim = masked.brds_pack_params(tabs, 0.75, 0.5, abstract=True)
        with pytest.warns(DeprecationWarning):
            _, jshim = jmasked.brds_pack_params(jabs, 0.75, 0.5,
                                                abstract=True)
        assert shim == jshim == want


@pytest.mark.parametrize("quant", [None, "int8"])
def test_lstm_abstract_pack_report_matches_reference(quant):
    cfg = LSTM_CONFIGS["lstm_ptb"]
    jm = JModel(JConfig(cfg.name, input_size=cfg.input_size,
                        hidden=cfg.hidden, vocab_size=cfg.vocab_size))
    jpol, pol = jlstm_policy(0.75, 0.5), lstm_policy(0.75, 0.5)
    if quant:
        jpol, pol = jpol.with_quant(JQuant(quant)), pol.with_quant(
            QuantConfig(quant))
    jabs = jm.abstract_params()
    _, want = jpol.compile(jabs).pack(jabs, abstract=True)
    tabs = LSTMModel(cfg).abstract_params()
    packed, got = pol.compile(tabs).pack(tabs, abstract=True)
    assert got == want
    assert all(packed["layers"][0][k].values.is_meta for k in ("w_x", "w_h"))


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_input_specs_match_reference(name, shape):
    got = input_specs(get_arch(name), SHAPES[shape])
    want = jinput_specs(jget_arch(name), JSHAPES[shape])
    assert got.keys() == want.keys()
    for k in got:
        if k == "cache":
            assert _port_leaves(got[k]) == _ref_leaves(want[k])
        else:
            assert got[k].is_meta
            assert (tuple(got[k].shape), _dt(got[k].dtype)) == (
                tuple(want[k].shape), _dt(want[k].dtype)), k


# ------------------------------------------------------------ kernel fakes

def _packed(rng, rows, ncols, ratio):
    w = torch.as_tensor(rng.standard_normal((rows, ncols)),
                        dtype=torch.float32)
    return P.pack(w, S.row_balanced_mask(w, ratio))


def _case():
    rng = np.random.default_rng(0)
    B, X, H, T = 3, 40, 16, 4
    sx, sh = _packed(rng, 4 * H, X, 0.75), _packed(rng, 4 * H, H, 0.5)
    f = lambda *s: torch.as_tensor(rng.standard_normal(s),  # noqa: E731
                                   dtype=torch.float32)
    fired = lambda *s: torch.as_tensor(rng.random(s) < 0.5)  # noqa: E731
    c = dict(B=B, X=X, H=H, sx=sx, sh=sh, qx=quantize_packed(sx, "int8"),
             qh=quantize_packed(sh, "int8"), x=f(B, X), h=f(B, H),
             bias=f(4 * H), c=f(B, H), z=f(B, 4 * H), dx=f(B, X),
             dh=f(B, H), fx=fired(B, X), fh=fired(B, H), m=f(B, 4 * H),
             xs=f(T, B, X), q=f(2, 4, 8, 16), k=f(2, 2, 8, 16),
             v=f(2, 2, 8, 16), qd=f(2, 4, 16),
             lengths=torch.tensor([8, 5], dtype=torch.int32))
    return c


def _calls(c):
    """(kernel, entry point call) of each of the 15 kernels."""
    H = c["H"]
    gates = (c["z"][:, :H], c["z"][:, H:2 * H], c["z"][:, 2 * H:3 * H],
             c["z"][:, 3 * H:])
    return {
        "rb_spmv": lambda o: o.rb_spmv(c["sx"], c["x"]),
        "rb_dual_spmv": lambda o: o.rb_dual_spmv(c["sx"], c["x"], c["sh"],
                                                 c["h"], c["bias"]),
        "lstm_gates": lambda o: o.lstm_gates(*gates, c["c"]),
        "fused_brds_lstm_step": lambda o: o.fused_brds_lstm_step(
            c["sx"], c["x"], c["sh"], c["h"], c["bias"], c["c"]),
        "delta_rb_spmv": lambda o: o.delta_rb_spmv(c["sx"], c["dx"],
                                                   c["fx"]),
        "delta_rb_dual_spmv": lambda o: o.delta_rb_dual_spmv(
            c["sx"], c["dx"], c["fx"], c["sh"], c["dh"], c["fh"], c["m"]),
        "fused_brds_delta_lstm_step": lambda o: o.fused_brds_delta_lstm_step(
            c["sx"], c["dx"], c["fx"], c["sh"], c["dh"], c["fh"], c["m"],
            c["bias"], c["c"]),
        "rb_spmv_q8": lambda o: o.rb_spmv_q8(c["qx"], c["x"]),
        "rb_dual_parts_q8": lambda o: o.rb_dual_spmv_q8(
            c["qx"], c["x"], c["qh"], c["h"], c["bias"]),
        "fused_brds_lstm_step_q8": lambda o: o.fused_brds_lstm_step_q8(
            c["qx"], c["x"], c["qh"], c["h"], c["bias"], c["c"]),
        "fused_brds_delta_lstm_step_q8":
            lambda o: o.fused_brds_delta_lstm_step_q8(
                c["qx"], c["dx"], c["fx"], c["qh"], c["dh"], c["fh"],
                c["m"], c["bias"], c["c"]),
        "fused_brds_lstm_scan": lambda o: o.fused_brds_lstm_scan(
            c["sx"], c["xs"], c["sh"], c["h"], c["bias"], c["c"]),
        "fused_brds_delta_lstm_scan": lambda o: o.fused_brds_delta_lstm_scan(
            c["sx"], c["xs"], c["sh"], c["h"], c["c"], c["x"], c["h"],
            c["m"], c["bias"], theta_x=0.05, theta_h=0.05),
        "flash_attention": lambda o: o.flash_attention(c["q"], c["k"],
                                                       c["v"]),
        "decode_attention": lambda o: o.decode_attention(
            c["qd"], c["k"], c["v"], c["lengths"],
            lse=torch.empty(2, 4, dtype=torch.float32)),
    }


def _fake_tree(mode, tree):
    if isinstance(tree, torch.Tensor):
        return mode.from_tensor(tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _fake_tree(mode, getattr(tree, f.name))
            for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), torch.Tensor)})
    if isinstance(tree, dict):
        return {k: _fake_tree(mode, v) for k, v in tree.items()}
    return tree


def _outs(out):
    out = out if isinstance(out, tuple) else (out,)
    return [(tuple(t.shape), t.dtype) for t in out]


@pytest.mark.parametrize("kernel", list(_calls(_case())))
def test_kernel_fake_matches_plain_version(kernel):
    """On fake tensors an entry point returns its plain version's shapes
    and dtypes, counts one fake launch and launches nothing."""
    c = _case()
    want = _outs(_calls(c)[kernel](_Ref()))
    ops.reset_kernel_flops()
    launches = dict(ops.LAUNCHES)
    mode = FakeTensorMode()
    with mode, ops.fakes_as_card():
        fc = _fake_tree(mode, c)
        got = _calls(fc)[kernel](ops)
    assert _outs(got) == want
    assert list(ops.KERNEL_FLOPS) == [kernel]
    work = ops.KERNEL_FLOPS[kernel]
    assert work["calls"] == 1 and sum(work[k] for k in ("fp32", "int8",
                                                         "bf16")) > 0
    assert dict(ops.LAUNCHES) == launches


class _Ref:
    """``ops`` with every entry point on its plain version."""

    def __getattr__(self, name):
        fn = getattr(ops, name)
        return lambda *a, **k: fn(*a, backend="ref", **k)


def test_live_pairs_counts_the_mask():
    """B15's fake counts the live (q, k) pairs of its mask, as a loop over
    the rows counts them."""
    for Sq, Sk, causal, window in [(5, 5, True, None), (3, 7, True, None),
                                   (4, 4, True, 2), (6, 10, True, 3),
                                   (4, 4, False, None), (1, 9, True, 4)]:
        want = 0
        for i in range(Sq):
            p = Sk - Sq + i
            if not causal:
                want += min(Sk, window or Sk)
            elif p >= 0:
                want += p - max(0, p - (window or Sk) + 1) + 1
        assert ops.live_pairs(Sq, Sk, causal, window) == want

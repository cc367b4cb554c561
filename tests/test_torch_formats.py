"""The port's sparse-format API on the CPU against the JAX reference: the
baseline masks (unstructured, block with tied and near-tied scores and a
ragged edge, bank-balanced), every registered format's pack / unpack /
stack / byte accounting / matvec / dual_matvec, the mixed-format
dual_matvec and ``SparsityPlan.matvec``. Inputs come from numpy with a
seed; the JAX matvecs run with ``backend="pallas"`` (interpret mode on the
CPU) and ``"ref"``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparsity as jS
from repro.sparse import SparsityPolicy as JPolicy
from repro.sparse import available_formats as javailable
from repro.sparse import dual_matvec as jdual_matvec
from repro.sparse import get_format as jget_format
from repro.sparse import lstm_policy as jlstm_policy
from repro_torch.core import sparsity as tS
from repro_torch.models import (masked_dense_from_numpy, packed_from_numpy,
                                packed_q8_from_numpy)
from repro_torch.sparse import (MaskedDense, SparseFormat, SparsityPolicy,
                                available_formats, dual_matvec, formats,
                                get_format, lstm_policy, register)

from test_torch_kernels import _arr, _close

ATOL = 1e-5   # float32 sums of at most 48 products in another order
OPTS = {"row_balanced": {}, "bank_balanced": {"num_banks": 4},
        "block": {"block": (4, 4)}, "unstructured": {},
        "row_balanced_q8": {"scheme": "int8"}}
FORMATS = sorted(OPTS)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _to_torch(rep):
    """The port's packed rep of a reference one."""
    if hasattr(rep, "scales"):
        return packed_q8_from_numpy(rep.values, rep.deltas, rep.scales,
                                    rep.ncols, rep.qmax, rep.frac_bits,
                                    rep.pad, rep.block_rows)
    if hasattr(rep, "deltas"):
        return packed_from_numpy(rep.values, rep.deltas, rep.ncols, rep.pad,
                                 rep.block_rows)
    return masked_dense_from_numpy(rep.values, rep.mask)


# ------------------------------------------------------------------ masks

def _tied_blocks(rng, shape):
    """Integer weights whose 4x4 blocks tie exactly in mean |w| (each
    block a permutation of one row of values), so only the stable
    tie-break by position orders them."""
    vals = np.array([1, -2, 3, -4] * 4, np.float32)
    w = np.empty(shape, np.float32)
    for i in range(0, shape[0], 4):
        for j in range(0, shape[1], 4):
            w[i:i + 4, j:j + 4] = rng.permutation(vals).reshape(4, 4)
    return w


@pytest.mark.parametrize("shape,spar,block,kind", [
    ((64, 48), 0.75, (4, 4), "random"),
    ((97, 33), 0.5, (4, 4), "random"),        # ragged edge: zero-padded
    ((384, 200), 0.75, (4, 4), "random"),     # near-tied scores
    ((64, 48), 0.6, (2, 8), "random"),
    ((64, 64), 0.5, (4, 4), "tied"),
    ((32, 48), 0.25, (4, 4), "tied"),
    ((40, 40), 0.5, (4, 4), "ones"),
])
def test_block_mask_matches_jax(shape, spar, block, kind):
    rng = np.random.default_rng(0)
    if kind == "random":
        w = _arr(rng, *shape)
    elif kind == "tied":
        w = _tied_blocks(rng, shape)
    else:
        w = np.ones(shape, np.float32)
    want = jS.block_mask(jnp.asarray(w), spar, block=block)
    _eq(tS.block_mask(_t(w), spar, block=block), want)


@pytest.mark.parametrize("shape,spar", [((64, 48), 0.75), ((97, 33), 0.5),
                                        ((8, 8), 0.0), ((30, 20), 0.9)])
@pytest.mark.parametrize("ties", [False, True])
def test_unstructured_mask_matches_jax(shape, spar, ties):
    rng = np.random.default_rng(1)
    w = _arr(rng, *shape)
    if ties:
        w = np.round(w * 2) / 2
    want = jS.unstructured_mask(jnp.asarray(w), spar)
    got = tS.unstructured_mask(_t(w), spar)
    _eq(got, want)
    assert tS.sparsity_of(got) == pytest.approx(jS.sparsity_of(want),
                                                abs=1e-7)


@pytest.mark.parametrize("shape,spar,banks", [((64, 48), 0.75, 4),
                                              ((30, 64), 0.5, 8),
                                              ((16, 12), 0.34, 3)])
@pytest.mark.parametrize("ties", [False, True])
def test_bank_balanced_mask_matches_jax(shape, spar, banks, ties):
    rng = np.random.default_rng(2)
    w = _arr(rng, *shape)
    if ties:
        w = np.round(w * 2) / 2
    _eq(tS.bank_balanced_mask(_t(w), spar, num_banks=banks),
        jS.bank_balanced_mask(jnp.asarray(w), spar, num_banks=banks))
    with pytest.raises(ValueError):
        tS.bank_balanced_mask(_t(w[:, :-1]), spar, num_banks=banks)


# ---------------------------------------------------------------- formats

def test_registry_matches_jax():
    assert available_formats() == javailable()
    with pytest.raises(KeyError):
        get_format("csr")
    with pytest.raises(ValueError):
        register(SparseFormat())


@pytest.mark.parametrize("name", FORMATS)
@pytest.mark.parametrize("shape,ratio", [((64, 48), 0.75), ((40, 32), 0.5)])
def test_format_pack_and_bytes_match_jax(name, shape, ratio):
    """mask, pack, unpack, stack, packed_bytes and memory_bytes equal to
    the reference's for every registered format."""
    rng = np.random.default_rng(3)
    w = _arr(rng, *shape)
    jf, tf, opts = jget_format(name), get_format(name), OPTS[name]
    jm = jf.mask(jnp.asarray(w), ratio, **opts)
    tm = tf.mask(_t(w), ratio, **opts)
    _eq(tm, jm)
    jp, tp = jf.pack(jnp.asarray(w), jm, **opts), tf.pack(_t(w), tm, **opts)
    for k in ("values", "deltas", "scales", "mask"):
        if hasattr(jp, k):
            _eq(getattr(tp, k), getattr(jp, k))
    assert isinstance(tp, MaskedDense) == (not hasattr(jp, "deltas"))
    _eq(tf.unpack(tp), jf.unpack(jp))
    assert tf.packed_bytes(*shape, ratio, torch.float32, **opts) == \
        jf.packed_bytes(*shape, ratio, jnp.float32, **opts)
    assert tf.memory_bytes(tp, **opts) == jf.memory_bytes(jp, **opts)
    jst, tst = jf.stack([jp, jp]), tf.stack([tp, tp])
    _eq(tst.values, jst.values)
    assert tst.values.shape == (2,) + tuple(tp.values.shape)
    ja = jf.abstract_pack(*shape, ratio, jnp.float32, **opts)
    ta = tf.abstract_pack(*shape, ratio, torch.float32, **opts)
    _same_abstract(ta, ja)
    _same_abstract(tf.abstract_stack(ta, 2), jf.abstract_stack(ja, 2))


def _same_abstract(got, want):
    """A dry-run stand-in of the port (``meta`` tensors) against the
    reference's (``ShapeDtypeStruct``s): the same rep type, and every
    tensor field of the same shape and dtype."""
    assert type(got).__name__ == type(want).__name__
    fields = [f for f in ("values", "deltas", "scales", "mask")
              if hasattr(want, f)]
    assert fields == [f for f in ("values", "deltas", "scales", "mask")
                      if hasattr(got, f)]
    for f in fields:
        g, w = getattr(got, f), getattr(want, f)
        assert g.is_meta, f
        assert tuple(g.shape) == tuple(w.shape), f
        assert str(g.dtype).removeprefix("torch.") == np.dtype(
            w.dtype).name, f
    for f in ("ncols", "qmax", "frac_bits"):
        assert getattr(got, f, None) == getattr(want, f, None), f


def _pair(name, seed, B=3, rows=64, X=48, H=32):
    """One format's packed A (rows, X) and B (rows, H) in both frameworks,
    with activations and a bias."""
    rng = np.random.default_rng(seed)
    wa, wb = _arr(rng, rows, X, scale=X ** -0.5), _arr(rng, rows, H,
                                                       scale=H ** -0.5)
    x, h, b = _arr(rng, B, X), _arr(rng, B, H), _arr(rng, rows, scale=0.1)
    jf, opts = jget_format(name), OPTS[name]
    ja = jf.pack(jnp.asarray(wa), jf.mask(jnp.asarray(wa), 0.75, **opts),
                 **opts)
    jb = jf.pack(jnp.asarray(wb), jf.mask(jnp.asarray(wb), 0.5, **opts),
                 **opts)
    return (dict(a=ja, b=jb, x=jnp.asarray(x), h=jnp.asarray(h),
                 bias=jnp.asarray(b)),
            dict(a=_to_torch(ja), b=_to_torch(jb), x=_t(x), h=_t(h),
                 bias=_t(b)))


@pytest.mark.parametrize("jbackend", ["pallas", "ref"])
@pytest.mark.parametrize("name", FORMATS)
def test_format_matvec_matches_jax(jbackend, name):
    """matvec and dual_matvec (with and without a bias) within ATOL of the
    reference's; the quantized format's equal (the same codes, integer
    sums)."""
    j, t = _pair(name, 4)
    jf, tf = jget_format(name), get_format(name)
    check = _eq if name == "row_balanced_q8" else _close
    check(tf.matvec(t["a"], t["x"]),
          jf.matvec(j["a"], j["x"], backend=jbackend))
    for bias in (None, "bias"):
        check(tf.dual_matvec(t["a"], t["x"], t["b"], t["h"],
                             None if bias is None else t[bias]),
              jf.dual_matvec(j["a"], j["x"], j["b"], j["h"],
                             None if bias is None else j[bias],
                             backend=jbackend))


@pytest.mark.parametrize("jbackend", ["pallas", "ref"])
@pytest.mark.parametrize("fa,fb", [("row_balanced", "bank_balanced"),
                                   ("block", "unstructured"),
                                   ("row_balanced_q8", "row_balanced")])
def test_mixed_format_dual_matvec_matches_jax(jbackend, fa, fb):
    ja_, ta = _pair(fa, 5)
    jb_, tb = _pair(fb, 6)
    want = jdual_matvec(jget_format(fa), ja_["a"], ja_["x"], jget_format(fb),
                        jb_["b"], jb_["h"], ja_["bias"], backend=jbackend)
    got = dual_matvec(get_format(fa), ta["a"], ta["x"], get_format(fb),
                      tb["b"], tb["h"], ta["bias"])
    _close(got, want)
    # a same-format pair takes the format's own dual path
    _close(dual_matvec(get_format(fa), ta["a"], ta["x"], get_format(fa),
                       ta["b"], ta["h"]),
           jdual_matvec(jget_format(fa), ja_["a"], ja_["x"],
                        jget_format(fa), ja_["b"], ja_["h"],
                        backend=jbackend))


def test_formats_module_exports():
    assert formats.MaskedDense is MaskedDense
    assert set(FORMATS) <= set(formats._REGISTRY)


# ------------------------------------------------------------------- plan

def _lstm_tree(seed, X=48, H=32):
    rng = np.random.default_rng(seed)
    return {"layers": [{"w_x": _arr(rng, 4 * H, X, scale=X ** -0.5),
                        "w_h": _arr(rng, 4 * H, H, scale=H ** -0.5),
                        "b": _arr(rng, 4 * H, scale=0.1)}]}


def _trees(tree):
    def mk(f):
        return {"layers": [{k: f(v) for k, v in lp.items()}
                           for lp in tree["layers"]]}
    return mk(jnp.asarray), mk(_t)


@pytest.mark.parametrize("jbackend", ["pallas", "ref"])
@pytest.mark.parametrize("rules", [
    "lstm",
    {"w_x$": ("block", 0.75, {"block": (4, 4)}),
     "w_h$": ("bank_balanced", 0.5, {"num_banks": 4})},
    {"w_x$": ("unstructured", 0.8), "w_h$": ("row_balanced_q8", 0.5)},
])
def test_plan_matvec_matches_jax(jbackend, rules):
    """SparsityPlan.matvec dispatches through each site's format: the
    pack report and every site's matvec equal to the reference's."""
    jtree, ttree = _trees(_lstm_tree(7))
    if rules == "lstm":
        jpolicy = jlstm_policy(0.75, 0.5, backend=jbackend)
        tpolicy = lstm_policy(0.75, 0.5)
    else:
        jpolicy = JPolicy.of(rules, layout="out_in", backend=jbackend)
        tpolicy = SparsityPolicy.of(rules, layout="out_in")
    jplan, tplan = jpolicy.compile(jtree), tpolicy.compile(ttree)
    jpruned, jmasks = jplan.prune(jtree)
    tpruned, tmasks = tplan.prune(ttree)
    jpacked, jrep = jplan.pack(jpruned, jmasks)
    tpacked, trep = tplan.pack(tpruned, tmasks)
    assert trep == jrep
    rng = np.random.default_rng(8)
    for key, n in (("w_x", 48), ("w_h", 32)):
        path = f"layers/0/{key}"
        x = _arr(rng, 3, n)
        want = jplan.matvec(path, jpacked["layers"][0][key], jnp.asarray(x))
        got = tplan.matvec(path, tpacked["layers"][0][key], _t(x))
        got_ref = tplan.matvec(path, tpacked["layers"][0][key], _t(x),
                               backend="ref")
        assert torch.equal(got, got_ref)
        if get_format(tplan.sites[path].rule.format).name == \
                "row_balanced_q8":
            _eq(got, want)
        else:
            _close(got, want)

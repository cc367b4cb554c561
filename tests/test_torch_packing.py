"""The port's row-balanced masks, packing and sparsity plan against the JAX
reference on the same inputs: integer outputs and packed arrays must be
identical, not close."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as jpack
from repro.core import sparsity as jsp
from repro.models import LSTMConfig as JConfig, LSTMModel as JModel
from repro.sparse import lstm_policy as jlstm_policy
from repro_torch.core import packing as tpack
from repro_torch.core import sparsity as tsp
from repro_torch.models import packed_from_numpy, params_from_numpy
from repro_torch.sparse import lstm_policy


def _weights(seed, rows, cols, ties=False):
    w = np.random.default_rng(seed).normal(size=(rows, cols))
    if ties:   # few distinct magnitudes: the stable tie-break decides
        w = np.round(w * 2) / 2
    return w.astype(np.float32)


def _same_packed(j, t):
    np.testing.assert_array_equal(np.asarray(j.values), t.values.numpy())
    np.testing.assert_array_equal(np.asarray(j.deltas), t.deltas.numpy())
    assert np.asarray(j.deltas).dtype == t.deltas.numpy().dtype
    assert (j.ncols, j.pad, j.block_rows, j.rows, j.K) == \
        (t.ncols, t.pad, t.block_rows, t.rows, t.K)


@pytest.mark.parametrize("ncols", [1, 7, 96, 128, 1500])
@pytest.mark.parametrize("spar", [0.0, 0.3, 0.5, 0.75, 0.875, 0.99])
def test_keep_count_matches(ncols, spar):
    assert tsp.keep_count(ncols, spar) == jsp.keep_count(ncols, spar)


@pytest.mark.parametrize("rows,cols,spar,ties", [
    (16, 64, 0.75, False), (24, 96, 0.5, True), (8, 33, 0.3, True),
    (4, 200, 0.875, False)])
def test_row_balanced_mask_matches(rows, cols, spar, ties):
    w = _weights(0, rows, cols, ties)
    want = np.asarray(jsp.row_balanced_mask(jnp.asarray(w), spar))
    got = tsp.row_balanced_mask(torch.from_numpy(w), spar).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got.sum(1) == tsp.keep_count(cols, spar)).all()


@pytest.mark.parametrize("rows,cols,spar,dtype", [
    (16, 64, 0.75, np.int8), (12, 128, 0.5, np.int8),
    (8, 129, 0.5, np.int16), (6, 1500, 0.75, np.int16),
    (2, 40000, 0.999, np.int32)])
def test_pack_matches(rows, cols, spar, dtype):
    """Values and delta-coded columns are identical arrays of the same
    narrow integer type; unpack and the byte accounting agree too."""
    w = _weights(1, rows, cols, ties=True)
    j = jpack.pack_from_dense(jnp.asarray(w), spar)
    t = tpack.pack_from_dense(torch.from_numpy(w), spar)
    _same_packed(j, t)
    assert t.deltas.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
    np.testing.assert_array_equal(t.col_indices().numpy(),
                                  np.asarray(j.col_indices()))
    np.testing.assert_array_equal(tpack.unpack(t).numpy(),
                                  np.asarray(jpack.unpack(j)))
    assert t.memory_bytes() == j.memory_bytes()


@pytest.mark.parametrize("rows,block", [(384, 256), (512, 256), (40, 256),
                                        (300, 64)])
def test_pad_packed_matches(rows, block):
    w = _weights(2, rows, 100)
    j = jpack.pad_packed(jpack.pack_from_dense(jnp.asarray(w), 0.75), block)
    t = tpack.pad_packed(tpack.pack_from_dense(torch.from_numpy(w), 0.75),
                         block)
    _same_packed(j, t)
    _same_packed(j.logical(), t.logical())
    assert t.memory_bytes() == j.memory_bytes()
    # padding an already padded struct is a no-op in both
    _same_packed(jpack.pad_packed(j, block), tpack.pad_packed(t, block))


def test_mask_rejects_1d_and_unbalanced():
    with pytest.raises(ValueError):
        tsp.row_balanced_mask(torch.ones(5), 0.5)
    mask = torch.zeros((2, 4), dtype=torch.bool)
    mask[0, :2] = True
    mask[1, :1] = True
    with pytest.raises(ValueError):
        tpack.pack(torch.ones((2, 4)), mask)


@pytest.fixture(scope="module")
def lstm_params():
    cfg = JConfig("t", input_size=40, hidden=24, num_layers=2, vocab_size=30)
    return JModel(cfg).init(jax.random.key(3))


def test_lstm_policy_plan_matches(lstm_params):
    """compile → prune → pack → summary on a 2-layer LSTM tree: masks,
    pruned weights, packed arrays and both reports are identical."""
    jplan = jlstm_policy(0.75, 0.5).compile(lstm_params)
    jpruned, jmasks = jplan.prune(lstm_params)
    jpacked, jrep = jplan.pack(jpruned, jmasks)
    tparams = params_from_numpy(jax.tree.map(np.asarray, lstm_params), "cpu")
    tplan = lstm_policy(0.75, 0.5).compile(tparams)
    tpruned, tmasks = tplan.prune(tparams)
    tpacked, trep = tplan.pack(tpruned, tmasks)
    assert sorted(tplan.sites) == sorted(jplan.sites)
    assert sorted(tmasks) == sorted(jmasks)
    for k in jmasks:
        np.testing.assert_array_equal(tmasks[k].numpy(),
                                      np.asarray(jmasks[k]))
    assert trep == jrep
    assert tplan.summary(tmasks) == jplan.summary(jmasks)
    for jl, tl, tpl in zip(jpacked["layers"], tpacked["layers"],
                           tpruned["layers"]):
        for key in ("w_x", "w_h"):
            _same_packed(jl[key], tl[key])
        np.testing.assert_array_equal(tl["b"].numpy(), np.asarray(jl["b"]))
    np.testing.assert_array_equal(tpacked["head"]["w"].numpy(),
                                  np.asarray(jpacked["head"]["w"]))
    # packing without the masks re-selects the same survivors
    _same_packed(jpacked["layers"][1]["w_h"],
                 tplan.pack(tpruned)[0]["layers"][1]["w_h"])


def test_lstm_policy_unported_rules_raise():
    """The delta and quant rules are ported: the policy and its plan carry
    them as the reference's do, and invalid rules still raise."""
    from repro.sparse import DeltaGateConfig as JDelta, QuantConfig as JQC
    from repro_torch.sparse import DeltaGateConfig, QuantConfig
    d, q = DeltaGateConfig(0.1, 0.05, cap_x=0.5), QuantConfig("q1.11")
    jp = jlstm_policy(0.5, 0.5, delta=JDelta(0.1, 0.05, cap_x=0.5),
                      quant=JQC("q1.11"))
    tp = lstm_policy(0.5, 0.5, delta=d, quant=q)
    assert (tp.activation, tp.quant) == (d, q)
    assert tp.with_activation(None).activation is None
    assert tp.with_quant(None).quant is None and tp.quant == q
    w = {"layers": [{"w_x": torch.zeros(8, 4), "w_h": torch.zeros(8, 2)}]}
    plan = tp.compile(w)
    assert (plan.activation, plan.quant) == (d, q)
    assert (jp.activation.theta_x, jp.quant.scheme) == (d.theta_x, q.scheme)
    with pytest.raises(ValueError):
        lstm_policy(1.0, 0.5)
    with pytest.raises(ValueError):
        DeltaGateConfig(theta_x=-1.0)
    with pytest.raises(ValueError):
        QuantConfig("int4")


@pytest.mark.parametrize("spec", ["int8", "q1.11"])
def test_lstm_policy_quant_plan_matches(lstm_params, spec):
    """A quant rule packs every row-balanced site to the reference's codes,
    scales and deltas, with the reference's byte report."""
    from repro.quant import QuantConfig as JQC
    from repro_torch.quant import QuantConfig
    jplan = jlstm_policy(0.75, 0.5, quant=JQC(spec)).compile(lstm_params)
    jpruned, jmasks = jplan.prune(lstm_params)
    jpacked, jrep = jplan.pack(jpruned, jmasks)
    tparams = params_from_numpy(jax.tree.map(np.asarray, lstm_params), "cpu")
    tplan = lstm_policy(0.75, 0.5, quant=QuantConfig(spec)).compile(tparams)
    tpruned, tmasks = tplan.prune(tparams)
    tpacked, trep = tplan.pack(tpruned, tmasks)
    assert trep == jrep
    for jl, tl in zip(jpacked["layers"], tpacked["layers"]):
        for key in ("w_x", "w_h"):
            for k in ("values", "deltas", "scales"):
                np.testing.assert_array_equal(
                    getattr(tl[key], k).numpy(), np.asarray(getattr(jl[key],
                                                                    k)))
            assert (tl[key].qmax, tl[key].frac_bits) == \
                (jl[key].qmax, jl[key].frac_bits)


def test_packed_from_numpy_carries_reference_packing():
    w = _weights(4, 300, 90)
    j = jpack.pad_packed(jpack.pack_from_dense(jnp.asarray(w), 0.6))
    t = packed_from_numpy(j.values, j.deltas, j.ncols, j.pad, j.block_rows)
    _same_packed(j, t)
    np.testing.assert_array_equal(tpack.unpack(t).numpy(),
                                  np.asarray(jpack.unpack(j)))

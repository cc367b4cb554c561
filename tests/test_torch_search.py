"""The port's Fig.-5 search (``sparse.search``, the ``core.brds`` shim) and
accuracy metrics (``core.metrics``) on the CPU against the JAX reference:
the same deterministic callbacks give the same history and best tuple,
and the metrics agree within 1e-6. Inputs come from numpy with a seed."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import brds as jbrds
from repro.core import metrics as jmetrics
from repro.models import LSTMConfig as JConfig, LSTMModel as JModel
from repro.sparse import lstm_policy as jlstm_policy
from repro.sparse import search as jsearch
from repro_torch.core import brds as tbrds
from repro_torch.core import metrics as tmetrics
from repro_torch.models import params_from_numpy
from repro_torch.sparse import lstm_policy, search as tsearch

METRIC_TOL = 1e-6   # float32 log-sum-exp and means in another order


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _landscape(kind):
    """Deterministic score functions of a tuple: asymmetric, monotone in
    Spar_x, monotone in Spar_h, and flat (ties keep the first best)."""
    return {"bowl": lambda sx, sh: -((sx - 0.7) ** 2) - 2.0 * (sh - 0.4) ** 2,
            "x": lambda sx, sh: sx - 0.1 * sh,
            "h": lambda sx, sh: sh - 0.1 * sx,
            "flat": lambda sx, sh: 0.0}[kind]


def _same_result(got, want):
    assert got.history == want.history
    assert (got.best_accuracy, got.best_spar_x, got.best_spar_h) == \
        (want.best_accuracy, want.best_spar_x, want.best_spar_h)


@pytest.mark.parametrize("kind", ["bowl", "x", "h", "flat"])
@pytest.mark.parametrize("kw", [dict(overall_sparsity=0.5),
                                dict(overall_sparsity=0.7, alpha=0.3,
                                     delta_x=0.08, delta_h=0.03),
                                dict(overall_sparsity=0.9, max_ratio=0.95)])
def test_plane_search_matches_jax(kind, kw):
    score = _landscape(kind)
    visits = {}

    def run(mod, tag):
        seen = visits.setdefault(tag, [])

        def visit(p, sx, sh):
            seen.append((sx, sh))
            return {"sx": sx, "sh": sh}, (sx, sh)

        return mod.plane_search({"sx": 0.0, "sh": 0.0}, visit=visit,
                                eval_fn=lambda p: score(p["sx"], p["sh"]),
                                **kw)

    want, got = run(jsearch, "jax"), run(tsearch, "torch")
    _same_result(got, want)
    assert got.best_policy == want.best_policy
    assert visits["torch"] == visits["jax"]


def test_brds_search_matches_jax():
    """brds_search over real policies on a tiny LSTM: each visit prunes to
    the policy's masks (equal to the reference's), and an eval callback
    that counts the surviving weights scores both packages alike."""
    cfg = dict(input_size=8, hidden=8, num_layers=1, vocab_size=11)
    jparams = JModel(JConfig("s", **cfg)).init(jax.random.key(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    seen = {"jax": [], "torch": []}

    def retrain(tag, to_np):
        def fn(pruned, plan, masks):
            seen[tag].append({k: to_np(m) for k, m in masks.items()})
            return pruned
        return fn

    def score(nnz_x, nnz_h):
        # favour a sparse W_x and a dense W_h, the paper's finding
        return float(nnz_h - 0.5 * nnz_x)

    def jeval(p):
        lp = p["layers"][0]
        return score(int(jnp.sum(lp["w_x"] != 0)), int(jnp.sum(lp["w_h"] != 0)))

    def teval(p):
        lp = p["layers"][0]
        return score(int((lp["w_x"] != 0).sum()), int((lp["w_h"] != 0).sum()))

    want = jsearch.brds_search(jparams, overall_sparsity=0.5,
                               policy_at=lambda sx, sh: jlstm_policy(sx, sh),
                               retrain_fn=retrain("jax", np.asarray),
                               eval_fn=jeval)
    got = tsearch.brds_search(tparams, overall_sparsity=0.5,
                              policy_at=lambda sx, sh: lstm_policy(sx, sh),
                              retrain_fn=retrain("torch",
                                                 lambda m: m.numpy()),
                              eval_fn=teval)
    _same_result(got, want)
    assert len(seen["torch"]) == len(seen["jax"]) > len(got.history) - 1
    for tm, jm in zip(seen["torch"], seen["jax"]):
        assert sorted(tm) == sorted(jm)
        for k in tm:
            np.testing.assert_array_equal(tm[k], jm[k])
    assert got.best_policy.match("layers/0/w_x").ratio == \
        want.best_policy.match("layers/0/w_x").ratio


def test_legacy_brds_search_shim_matches_jax():
    def prune_fn(p, sx, sh):
        return {"sx": sx, "sh": sh}, None

    kw = dict(overall_sparsity=0.5, prune_fn=prune_fn,
              retrain_fn=lambda p, masks: p,
              eval_fn=lambda p: -abs(p["sx"] - 0.65) - abs(p["sh"] - 0.4))
    with pytest.warns(DeprecationWarning):
        want = jbrds.brds_search({"sx": 0.0, "sh": 0.0}, **kw)
    with pytest.warns(DeprecationWarning, match="repro_torch.sparse"):
        got = tbrds.brds_search({"sx": 0.0, "sh": 0.0}, **kw)
    _same_result(got, want)
    assert got.best_policy is None


@pytest.mark.parametrize("args", [(0.5, 0.25, 0.05, 0.05, 2.0, 3),
                                  (0.75, 0.1, 0.02, 0.04, 1.5, 7)])
def test_execution_time_model_matches_jax(args):
    assert tsearch.execution_time_model(*args) == \
        jsearch.execution_time_model(*args)
    assert tbrds.execution_time_model is tsearch.execution_time_model


# ---------------------------------------------------------------- metrics

@pytest.mark.parametrize("shape", [(3, 5, 7), (4, 11)])
@pytest.mark.parametrize("masked", [False, True, "zeros"])
def test_cross_entropy_matches_jax(shape, masked):
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=shape) * 3).astype(np.float32)
    labels = rng.integers(0, shape[-1], size=shape[:-1])
    mask = None
    if masked == "zeros":
        mask = np.zeros(shape[:-1], np.float32)
    elif masked:
        mask = (rng.random(shape[:-1]) < 0.6).astype(np.float32)
    want = float(jmetrics.cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask)))
    got = float(tmetrics.cross_entropy(_t(logits), _t(labels),
                                       None if mask is None else _t(mask)))
    assert got == pytest.approx(want, abs=METRIC_TOL)
    assert tmetrics.perplexity(got) == pytest.approx(
        jmetrics.perplexity(want), rel=METRIC_TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_accuracies_match_jax(masked):
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(4, 6, 5)).astype(np.float32)
    labels = rng.integers(0, 5, size=(4, 6))
    mask = (rng.random((4, 6)) < 0.5).astype(np.float32) if masked else None
    want = jmetrics.token_accuracy(jnp.asarray(logits), jnp.asarray(labels),
                                   None if mask is None else jnp.asarray(mask))
    got = tmetrics.token_accuracy(_t(logits), _t(labels),
                                  None if mask is None else _t(mask))
    assert isinstance(got, float)
    assert got == pytest.approx(want, abs=METRIC_TOL)
    blog = rng.normal(size=(9, 1)).astype(np.float32)
    blab = rng.integers(0, 2, size=(9,))
    assert tmetrics.binary_accuracy(_t(blog), _t(blab)) == pytest.approx(
        jmetrics.binary_accuracy(jnp.asarray(blog), jnp.asarray(blab)),
        abs=METRIC_TOL)


def test_core_exports_match_reference():
    import repro.core as jcore
    import repro_torch.core as tcore
    names = ("row_balanced_mask", "unstructured_mask", "block_mask",
             "bank_balanced_mask", "apply_mask", "sparsity_of", "keep_count",
             "RowBalancedSparse", "pack", "unpack", "pack_from_dense",
             "brds_search", "BRDSResult", "execution_time_model", "metrics")
    for n in names:
        assert hasattr(jcore, n) and hasattr(tcore, n), n
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        import repro_torch.sparse  # noqa: F401  (no warning at import)

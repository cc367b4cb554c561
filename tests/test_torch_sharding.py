"""The port's sharding rules, partition permutation and mesh helpers against
the JAX reference's, in-process (no ranks): ``resolve_spec`` over the rule
table with a duck-typed mesh (the reference reads only ``axis_names`` and
``devices.shape``), the DTensor placements it implies, ``rules_for`` /
``use_rules``, ``gate_row_permutation`` and ``permute_packed_rows`` on the
same packed tree, the LSTM's sharded cache declaration and
``cache_shardings``, and the errors of what waits for slice 19."""
import types

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro import sharding as J
from repro.dist import partition as JP
from repro.models import LSTMConfig as JConfig, LSTMModel as JModel
from repro_torch import sharding as T
from repro_torch.dist import partition as TP
from repro_torch.launch import mesh as M
from repro_torch.models import (LSTMConfig, LSTMModel, packed_from_numpy,
                                packed_q8_from_numpy)
from repro_torch.obs import collectives
from repro_torch.serving import cache_shardings

MESHES = [(1, 2), (2, 2), (1, 4), (16, 16)]
DIMS = (1, 2, 3, 4, 8, 12, 16, 30, 64, 96, 256, 1500, 6000)


def _mesh(shape, axes=("data", "model")):
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))


def _specs(rules):
    """Every rule name alone and beside each other name, over DIMS."""
    names = sorted(rules) + [None]
    for a in names:
        for d in DIMS:
            yield (a,), (d,)
            for b in names:
                yield (a, b), (d, 2 * d)
                yield (a, b), (d, 3)


@pytest.mark.parametrize("layout", ["tp", "dp"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_resolve_spec_matches_reference(shape, layout):
    cfg = types.SimpleNamespace(layout=layout)
    jr, tr = J.rules_for(cfg), T.rules_for(cfg)
    assert tr == jr
    mesh = _mesh(shape)
    for logical, dims in _specs(jr):
        want = tuple(J.resolve_spec(mesh, logical, dims, jr))
        assert T.resolve_spec(mesh, logical, dims, tr) == want, \
            (logical, dims)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_placements_follow_the_spec(shape):
    """Shard(d) on the mesh dims a tensor dim resolved to, Replicate()
    elsewhere; a joint (data, model) dim shards on both."""
    mesh = _mesh(shape)
    for logical, dims in _specs(T.DEFAULT_RULES):
        spec = T.resolve_spec(mesh, logical, dims)
        got = T.placements(mesh, logical, dims)
        for ax, pl in zip(("data", "model"), got):
            owners = [d for d, e in enumerate(spec)
                      if e == ax or (isinstance(e, tuple) and ax in e)]
            assert pl == (Shard(owners[0]) if owners else Replicate())
    both = T.placements(mesh, ("batch",), (shape[0] * shape[1],),
                        T.dp_rules())
    assert both == (Shard(0), Shard(0))


def test_active_rules_and_axes():
    assert T.active_rules() is None
    with T.use_rules(T.dp_rules()) as r:
        assert T.active_rules() is r
        assert T.resolve_spec(_mesh((2, 2)), ("mlp",), (64,)) == (None,)
    assert T.active_rules() is None
    assert T.resolve_spec(_mesh((2, 2)), ("mlp",), (64,)) == ("model",)
    assert T.Axes("embed", "mlp") == ("embed", "mlp")
    assert T.mesh_axes(_mesh((2, 4))) == {"data": 2, "model": 4}
    dm = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                               shape=(2, 4))
    assert T.mesh_axes(dm) == {"data": 2, "model": 4}
    assert TP.model_axis_size(dm) == JP.model_axis_size(_mesh((2, 4))) == 4
    assert TP.data_axis_size(_mesh((2, 4))) == 2
    assert TP.model_axis_size(_mesh((4,), ("data",))) == 1


@pytest.mark.parametrize("hidden,shards", [(2, 2), (4, 1), (64, 2), (64, 4),
                                           (64, 8), (1500, 4), (1500, 2)])
def test_gate_row_permutation_matches_reference(hidden, shards):
    np.testing.assert_array_equal(TP.gate_row_permutation(hidden, shards),
                                  JP.gate_row_permutation(hidden, shards))


def test_gate_row_permutation_rejects_uneven():
    for fn in (TP.gate_row_permutation, JP.gate_row_permutation):
        with pytest.raises(ValueError, match="not divisible"):
            fn(30, 4)


@pytest.fixture(scope="module")
def packed():
    """The reference's packed (and int8-quantized) W_x / W_h of a 2-layer
    H=64 LSTM with its biases, keyed by quant scheme."""
    import jax.numpy as jnp
    from repro.core.packing import pack_from_dense
    from repro.quant import quantize_packed
    rng = np.random.default_rng(0)
    layers = [{"w_x": pack_from_dense(jnp.asarray(rng.normal(size=(256, n))),
                                      0.75),
               "w_h": pack_from_dense(jnp.asarray(rng.normal(size=(256, 64))),
                                      0.5),
               "b": jnp.asarray(rng.normal(size=256))} for n in (16, 64)]
    q8 = [{k: quantize_packed(v, "int8") if k != "b" else v
           for k, v in lp.items()} for lp in layers]
    return {None: {"layers": layers}, "int8": {"layers": q8}}


def _port_copy(s):
    if hasattr(s, "scales"):
        return packed_q8_from_numpy(s.values, s.deltas, s.scales, s.ncols,
                                    s.qmax, s.frac_bits, s.pad, s.block_rows)
    return packed_from_numpy(s.values, s.deltas, s.ncols, s.pad,
                             s.block_rows)


@pytest.mark.parametrize("quant", [None, "int8"], ids=["float", "int8"])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_permute_packed_rows_matches_reference(packed, quant, shards):
    """Values, deltas, q8 scales and the bias move together, as the
    reference's do, and only the rows move."""
    perm = JP.gate_row_permutation(64, shards)
    for lp in packed[quant]["layers"]:
        for key in ("w_x", "w_h"):
            j = JP.permute_packed_rows(lp[key], perm)
            t = TP.permute_packed_rows(_port_copy(lp[key]), perm)
            fields = ("values", "deltas") + (("scales",) if quant else ())
            for f in fields:
                np.testing.assert_array_equal(getattr(t, f).numpy(),
                                              np.asarray(getattr(j, f)))
            assert (t.ncols, t.rows, t.pad) == (j.ncols, j.rows, j.pad)
        np.testing.assert_array_equal(
            TP.permute_packed_rows(torch.tensor(np.asarray(lp["b"])),
                                   perm).numpy(),
            np.asarray(JP.permute_packed_rows(lp["b"], perm)))


def test_is_partitionable_and_supports_dist(packed):
    tree = {"layers": [{k: _port_copy(v) if hasattr(v, "deltas") else v
                        for k, v in lp.items()}
                       for lp in packed[None]["layers"]]}
    assert TP.is_partitionable(tree) == JP.is_partitionable(packed[None])
    assert not TP.is_partitionable({"layers": [{"w_x": torch.zeros(2)}]})
    assert not TP.is_partitionable({})
    model = LSTMModel(LSTMConfig("t", 16, 64, 2, 50))
    assert TP.supports_dist(model, _mesh((1, 2)))
    assert not TP.supports_dist(model, _mesh((2,), ("data",)))
    # a dense tree passes; a model axis of 1 has nothing to check
    TP.check_partitioned({"layers": [{"w_x": torch.zeros(4, 2)}]},
                         _mesh((1, 2)))
    TP.check_partitioned(tree, _mesh((2, 1)))
    with pytest.raises(ValueError, match="not dist-partitioned"):
        TP.check_partitioned(tree, _mesh((1, 2)))


@pytest.mark.parametrize("delta", [False, True], ids=["float", "delta"])
@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_cache_declaration(shape, delta):
    """Under a mesh the LSTM declares its rank's cache: c (B, H/n) and m
    (B, 4H/n), the rest as unsharded; ``cache_shardings`` resolves the
    whole cache's placements as the reference's ``cache_shardings`` does
    (its rules over the logical axes and the whole shapes)."""
    from repro.sparse import DeltaGateConfig as JDelta
    from repro_torch.sparse import DeltaGateConfig
    mesh = _mesh(shape)
    n = shape[1]
    model = LSTMModel(LSTMConfig("t", 16, 64, 2, 50),
                      delta=DeltaGateConfig() if delta else None)
    jmodel = JModel(JConfig("t", 16, 64, 2, 50),
                    delta=JDelta() if delta else None, mesh=mesh)
    sharded = model.with_mesh(mesh)
    whole, local = model.cache_defs(4, 20), sharded.cache_defs(4, 20)
    for lw, ll in zip(whole["layers"], local["layers"]):
        assert ll["c"].shape == (4, 64 // n) and ll["c"].axes == (
            "batch", "lstm_hidden_shard")
        for k in lw:
            if k not in ("c", "m"):
                assert ll[k].shape == lw[k].shape
        if delta:
            assert ll["m"].shape == (4, 4 * 64 // n)
    assert sharded.init_cache(4, 20, "cpu")["layers"][0]["c"].shape == \
        (4, 64 // n)
    assert [c.shape for c, _ in sharded.init_state(4, "cpu")] == \
        [(4, 64 // n)] * 2
    from repro.models import layers as JL
    jdefs = jmodel.cache_defs(4, 20)
    want = jax.tree.map(
        lambda lg, sh: J.resolve_spec(mesh, lg, sh), JL.param_axes(jdefs),
        JL.param_shapes(jdefs),
        is_leaf=lambda x: isinstance(x, tuple) and all(
            isinstance(e, (str, type(None))) for e in x))
    got = cache_shardings(mesh, sharded, 4, 20)
    for gl, wl in zip(got["layers"], want["layers"]):
        assert sorted(gl) == sorted(wl)
        for k in gl:
            spec = tuple(wl[k])
            assert gl[k] == tuple(
                Shard(spec.index(ax)) if ax in spec else Replicate()
                for ax in ("data", "model")), k


def test_mesh_backends_and_unported():
    """The backend is explicit: gloo on the CPU, NCCL refused there and
    refused for more ranks than cards; the production meshes name the
    ranks they need; ``constrain`` is the identity on a plain tensor;
    ``spec_tree`` maps over trees; the HLO reader raises by name, and
    ``top`` reports a dry-run cell's collectives in the reference's
    records."""
    assert M.backend_for("cpu", 4) == "gloo"
    assert M.backend_for("cpu", 4, "gloo") == "gloo"
    with pytest.raises(ValueError, match="gloo"):
        M.backend_for("cpu", 2, "nccl")
    with pytest.raises(ValueError, match="'nccl' or 'gloo'"):
        M.backend_for("cpu", 2, "mpi")
    with pytest.raises(ValueError, match="refuses two ranks on one card"):
        M.backend_for("cuda", torch.cuda.device_count() + 1, "nccl")
    assert M.backend_for("cuda", 4, "gloo") == "gloo"
    assert M.rank_device("cpu", 3) == torch.device("cpu")
    with pytest.raises(RuntimeError, match="initialized process group"):
        M.make_host_mesh(1, 2)
    with pytest.raises(ValueError, match="needs 256 ranks"):
        M.make_production_mesh()
    with pytest.raises(ValueError, match="needs 512 ranks"):
        M.make_production_mesh(multi_pod=True)
    x = torch.zeros(1)
    assert T.constrain(x, "batch") is x
    fake = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty((2, 4)))
    tree = T.spec_tree(fake, {"a": ("batch", "mlp"), "b": [("vocab",)]},
                       {"a": (4, 8), "b": [(6,)]})
    assert tree["a"].placements == (Shard(0), Shard(1))
    assert tree["a"].spec == ("data", "model")
    assert tree["b"][0].placements == (Replicate(), Replicate())
    with pytest.raises(NotImplementedError, match="HLO"):
        collectives.inventory_from_text("ENTRY e {}")
    # top: the reference's record keys (its HLO reader on one
    # all-reduce), largest first, over the dry run's traced cell
    from repro.obs import collectives as jcollectives
    want = jcollectives.inventory_from_text(_ONE_ALL_REDUCE)
    try:
        items = collectives.top("qwen3-0.6b", "decode_32k", n=3)
    finally:
        torch.distributed.destroy_process_group()
    assert items and all(it.keys() == want[0].keys() for it in items)
    wire = [it["wire_bytes"] for it in items]
    assert wire == sorted(wire, reverse=True)
    assert all(it["wire_bytes"] == it["bytes"] * it["mult"] for it in items)


_ONE_ALL_REDUCE = """HloModule m

ENTRY %main (p: f32[8]) -> f32[8] {
  %p = f32[8] parameter(0)
  ROOT %ar = f32[8] all-reduce(f32[8] %p), replica_groups={{0,1}}
}
"""


def test_inventory_counts_without_a_mesh():
    """A step with no collective inventories empty: the one-card decode
    pays nothing."""
    model = LSTMModel(LSTMConfig("t", 16, 32, 1, 50))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    cache = model.init_cache(2, 8, "cpu")
    items = collectives.decode_step_inventory(
        model, params, cache, torch.zeros((2, 1), dtype=torch.long), 0)
    assert items == []
    assert collectives.summarize_inventory(items) == {"counts": {},
                                                      "wire_bytes": 0}

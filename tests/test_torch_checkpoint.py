"""Checkpoints and the fault loop in the port (``repro_torch.training``
``checkpoint`` / ``fault``): the reference's tests on the port, and
checkpoints carried both ways between the packages — the same keys,
checksums and bytes, optimizer state and bfloat16 leaves included."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import LSTMConfig as JConfig, LSTMModel as JModel
from repro.training import CheckpointManager as JCheckpointManager
from repro.training import OptConfig as JOpt, init_state as jinit_state
from repro_torch.models import LSTMConfig, LSTMModel, params_from_numpy
from repro_torch.training import (CheckpointManager, OptConfig,
                                  ResilientLoop, StragglerMonitor,
                                  elastic_restore, init_state)
from repro_torch.training.tree import leaves, leaves_with_keys

KW = dict(input_size=24, hidden=32, num_layers=2, vocab_size=64)


def _state(v: float):
    return {"w": torch.full((4, 4), v), "step_count": torch.tensor(v)}


def _meta(d, step):
    with open(os.path.join(str(d), f"step_{step:08d}", "meta.json")) as f:
        return json.load(f)


# ----------------------------------------------- the reference's checks

def test_save_restore_roundtrip(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    ckpt.save(10, _state(1.5), extra={"note": "x"})
    got, meta = ckpt.restore(_state(0.0))
    assert meta["step"] == 10 and meta["extra"] == {"note": "x"}
    assert torch.equal(got["w"], torch.full((4, 4), 1.5))


def test_keep_k_pruning(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        ckpt.save(s, _state(float(s)))
    assert ckpt.all_steps() == [3, 4]


def test_corrupted_checkpoint_skipped(tmp_path):
    """A node dying mid-save must not poison the restore path."""
    ckpt = CheckpointManager(str(tmp_path), keep=5, async_save=False)
    ckpt.save(1, _state(1.0))
    ckpt.save(2, _state(2.0))
    p = os.path.join(str(tmp_path), "step_00000002", "arrays_p0.npz")
    with open(p, "wb") as f:
        f.write(b"garbage")
    assert ckpt.latest_step() == 1
    got, meta = ckpt.restore(_state(0.0))
    assert meta["step"] == 1
    assert float(got["w"][0, 0]) == 1.0


def test_tmp_dir_never_committed(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=5, async_save=False)
    os.makedirs(os.path.join(str(tmp_path), "step_00000009.tmp"))
    assert ckpt.all_steps() == []
    with pytest.raises(FileNotFoundError):
        ckpt.restore(_state(0.0))


def test_async_save_copies_before_returning(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    st = _state(5.0)
    ckpt.save(5, st)
    st["w"].fill_(7.0)          # the saved copy was taken at save()
    ckpt.wait()
    assert ckpt.latest_step() == 5
    got, _ = ckpt.restore(_state(0.0))
    assert float(got["w"][0, 0]) == 5.0


def test_resilient_loop_recovers(tmp_path):
    """The step function raises twice; the loop restores and replays to
    the end, every increment applied exactly once."""
    ckpt = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    fail_at = {7: 2}

    def step_fn(state, step):
        if fail_at.get(step, 0) > 0:
            fail_at[step] -= 1
            raise RuntimeError("simulated node failure")
        return {"w": state["w"] + 1.0,
                "step_count": state["step_count"] + 1}

    loop = ResilientLoop(ckpt, save_every=2, max_failures=5)
    state, end = loop.run(_state(0.0), step_fn, 0, 10)
    assert end == 10 and loop.failures == 2
    assert float(state["w"][0, 0]) == 10.0


def test_resilient_loop_gives_up(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=3, async_save=False)

    def step_fn(state, step):
        raise RuntimeError("permanent failure")

    loop = ResilientLoop(ckpt, save_every=2, max_failures=2)
    with pytest.raises(RuntimeError):
        loop.run(_state(0.0), step_fn, 0, 5)
    # no checkpoint to fall back on: the first failure is raised
    loop = ResilientLoop(CheckpointManager(str(tmp_path / "empty")),
                         max_failures=5)
    with pytest.raises(RuntimeError):
        loop.run(_state(0.0), step_fn, 0, 5)
    assert loop.failures == 1


def test_straggler_monitor():
    mon = StragglerMonitor(threshold=2.0, alpha=0.5)
    for _ in range(10):
        mon.record(1.0)
    assert not mon.record(1.5)
    assert mon.record(5.0)
    assert mon.flagged == 1
    assert mon.ema == pytest.approx(1.0, abs=0.3)


def test_resilient_loop_straggler_hook(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    clock = {"t": 0.0}
    times = iter([1.0] * 8 + [30.0] + [1.0] * 3)

    def step_fn(state, step):
        clock["t"] += next(times)
        return state

    events = []
    loop = ResilientLoop(ckpt, save_every=100,
                         straggler=StragglerMonitor(threshold=3.0),
                         on_straggler=lambda s, m: events.append(s),
                         clock=lambda: clock["t"])
    loop.run(_state(0.0), step_fn, 0, 12)
    assert events == [8]


def test_resharding_restore_raises(tmp_path):
    """Re-sharding restores are ported (``tests/test_torch_sharded_train.
    py`` restores a (2, 2) checkpoint on (1, 2) and one device): a
    sharding tree of None leaves restores whole tensors, as no sharding
    does, and a leaf that is not a NamedSharding raises by name."""
    ckpt = CheckpointManager(str(tmp_path), async_save=False)
    ckpt.save(1, _state(1.0))
    plain, meta = ckpt.restore(_state(0.0))
    got, meta2 = elastic_restore(ckpt, _state(0.0),
                                 {"w": None, "step_count": None})
    assert meta2 == meta
    for a, b in zip(leaves(got), leaves(plain)):
        assert torch.equal(a, b)
    with pytest.raises(TypeError, match="NamedSharding"):
        ckpt.restore(_state(0.0), shardings=object())
    with pytest.raises(TypeError, match="NamedSharding"):
        elastic_restore(ckpt, _state(0.0), object())


# ------------------------------------------------- across the packages

@pytest.fixture(scope="module")
def trees():
    """The same (params, AdamW state) in both packages: the LSTM at a
    small width, moments made nonzero, plus a bfloat16 leaf."""
    jm = JModel(JConfig("t", **KW))
    jp = jm.init(jax.random.key(0))
    jst = jinit_state(JOpt(), jp)
    rng = np.random.default_rng(0)
    jst = {"m": jax.tree.map(lambda x: jnp.asarray(
               rng.normal(size=x.shape).astype(np.float32)), jst["m"]),
           "v": jax.tree.map(lambda x: jnp.asarray(
               rng.random(size=x.shape).astype(np.float32)), jst["v"]),
           "count": jnp.int32(7)}
    bf = rng.normal(size=(3, 5)).astype(np.float32)
    jtree = (jp, jst, {"bf16": jnp.asarray(bf, jnp.bfloat16)})
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tst = {"m": params_from_numpy(jax.tree.map(np.asarray, jst["m"]), "cpu"),
           "v": params_from_numpy(jax.tree.map(np.asarray, jst["v"]), "cpu"),
           "count": torch.tensor(7, dtype=torch.int32)}
    ttree = (tp, tst, {"bf16": torch.tensor(bf).to(torch.bfloat16)})
    return jtree, ttree


def _bits(t):
    t = t.detach()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def test_keys_are_keystr(trees):
    jtree, ttree = trees
    jkeys = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_flatten_with_path(jtree)[0]]
    assert [k for k, _ in leaves_with_keys(ttree)] == jkeys
    assert "[0]['layers'][1]['w_x']" in jkeys


def test_jax_to_port_and_back_bitwise(trees, tmp_path):
    """A checkpoint the reference writes restores in the port bit for bit
    (optimizer state and the bfloat16 leaf too) and the port's own save of
    the same tree has the same checksum and arrays; a checkpoint the port
    writes restores in the reference bit for bit."""
    jtree, ttree = trees
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    JCheckpointManager(str(jdir), async_save=False).save(3, jtree)
    CheckpointManager(str(tdir), async_save=False).save(3, ttree)
    assert _meta(jdir, 3)["checksum"] == _meta(tdir, 3)["checksum"]
    with np.load(jdir / "step_00000003" / "arrays_p0.npz") as zj, \
            np.load(tdir / "step_00000003" / "arrays_p0.npz") as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            assert zj[k].tobytes() == zt[k].tobytes(), k
            assert zj[k].shape == zt[k].shape, k

    template = jax.tree.map(torch.zeros_like, ttree)
    got, meta = CheckpointManager(str(jdir)).restore(template)
    assert meta["step"] == 3
    for (k, a), b in zip(leaves_with_keys(got), leaves(ttree)):
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=k)

    # the reference's restore cannot cast bfloat16 words back (numpy has
    # no cast from its V2 records, for its own checkpoints too), so the
    # port → reference direction is held on the float32 / int32 trees
    tdir2 = tmp_path / "port2"
    CheckpointManager(str(tdir2), async_save=False).save(4, ttree[:2])
    jtemplate = jax.tree.map(jnp.zeros_like, jtree[:2])
    jgot, jmeta = JCheckpointManager(str(tdir2)).restore(jtemplate)
    assert jmeta["step"] == 4
    for a, b in zip(jax.tree.leaves(jgot), leaves(ttree[:2])):
        assert np.asarray(a).dtype == b.numpy().dtype
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_restore_to_a_device_and_dtype(trees, tmp_path):
    _, ttree = trees
    ckpt = CheckpointManager(str(tmp_path), async_save=False)
    ckpt.save(1, ttree[0])
    template = jax.tree.map(lambda t: torch.zeros_like(t,
                                                        dtype=torch.float64),
                            ttree[0])
    got, _ = ckpt.restore(template, device="cpu")
    for a, b in zip(leaves(got), leaves(ttree[0])):
        assert a.dtype == torch.float64
        assert torch.equal(a, b.double())


def test_train_state_resumes_across_packages(tmp_path):
    """The port's (params, opt_state) after two steps, saved and restored
    by the reference, is the same state (count and moments included)."""
    from repro_torch.training import make_train_step
    import types
    m = LSTMModel(LSTMConfig("t", **KW))
    p = m.init(device="cpu")
    oc = OptConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    st = init_state(oc, p)
    step = make_train_step(m, types.SimpleNamespace(grad_accum=1), oc)
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, 64, (2, 6)))
    for i in range(2):
        p, st, _ = step(p, st, {"inputs": toks, "labels": toks}, i)
    CheckpointManager(str(tmp_path), async_save=False).save(2, (p, st))
    jtemplate = jax.tree.map(lambda t: jnp.zeros(t.shape, t.numpy().dtype),
                             (p, st))
    jgot, _ = JCheckpointManager(str(tmp_path)).restore(jtemplate)
    assert int(jgot[1]["count"]) == 2
    for a, b in zip(jax.tree.leaves(jgot), leaves((p, st))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())

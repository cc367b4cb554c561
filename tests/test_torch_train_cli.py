"""The training CLI (``repro_torch.launch.train``) on the CPU against the
reference's (``repro.launch.train``): the same flags and defaults plus
``--device``, the same model and BRDS summary lines, the first step's
loss equal to the reference's loss on the same weights and batch, and the
restart path: checkpoints every ``--save-every`` steps, an injected
failure restored and replayed from the newest one, auto-resume, masks
held through it all."""
import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.training
from repro.configs import smoke_config as jsmoke_config
from repro.launch import train as jtrain
from repro.models import build_model as jbuild_model
from repro_torch.configs import smoke_config
from repro_torch.launch import train
from repro_torch.models import build_model
from repro_torch.sparse import transformer_policy
from repro_torch.training import CheckpointManager, ZipfInduction
from repro_torch.training.tree import leaves

ARGS = ["--arch", "qwen3-0.6b", "--smoke", "--steps", "6", "--batch", "4",
        "--seq", "32", "--brds", "--save-every", "2"]


class _Stop(Exception):
    pass


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # many tiny ops: torch's intra-op threads only contend here
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_parser(monkeypatch):
    """The reference CLI's parser, caught as its ``main`` parses."""
    got = {}

    def parse(self, args=None, namespace=None):
        got["parser"] = self
        raise _Stop
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse)
    with pytest.raises(_Stop):
        jtrain.main()
    monkeypatch.undo()
    return got["parser"]


def _options(ap):
    return {a.dest: (tuple(a.option_strings), a.default, a.type,
                     tuple(a.choices) if a.choices else None)
            for a in ap._actions if a.dest != "help"}


def test_flags_and_defaults_match(monkeypatch):
    """The reference's flags and defaults, but for ``--device`` (added),
    ``--ckpt-dir``'s default (the reference's
    fixed /tmp path becomes a fresh temporary directory, None here) and
    ``--mesh``, which takes DATA,MODEL beside the reference's three
    choices (checked by the parser's own code, not argparse's
    ``choices``)."""
    ours = _options(train.parser())
    ref = _options(_reference_parser(monkeypatch))
    assert ours.pop("device") == (("--device",), None, None, None)
    assert ours.pop("ckpt_dir") == (("--ckpt-dir",), None, None, None)
    assert ref.pop("ckpt_dir") == (("--ckpt-dir",), "/tmp/repro_ckpt", None,
                                   None)
    assert ours.pop("mesh") == (("--mesh",), "host", None, None)
    assert ref.pop("mesh") == (("--mesh",), "host", None,
                               ("host", "pod", "multipod"))
    assert ours == ref


def test_default_ckpt_dir_is_private(tmp_path, monkeypatch):
    """Without ``--ckpt-dir`` the run checkpoints into a fresh directory
    under its own TMPDIR, never the reference's shared /tmp/repro_ckpt,
    resumes from nothing, and removes the directory at its end; a
    checkpoint left in another run's directory is not picked up."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr("tempfile.tempdir", None)
    stale = tmp_path / "stale"
    train.main(ARGS + ["--steps", "2", "--save-every", "1", "--device",
                       "cpu", "--ckpt-dir", str(stale)])
    assert CheckpointManager(str(stale)).all_steps() == [1, 2]
    out = train.main(ARGS + ["--steps", "2", "--save-every", "1",
                             "--device", "cpu"])
    ck = out["ckpt_dir"]
    assert os.path.abspath(ck) != "/tmp/repro_ckpt"
    assert os.path.dirname(ck) == str(tmp_path)
    assert os.path.basename(ck).startswith("repro_torch_ckpt_")
    assert out["resumed_from"] == [] and sorted(out["losses"]) == [0, 1]
    assert not os.path.exists(ck)


def test_mesh_shape_checked():
    """``--mesh`` takes host, pod, multipod or DATA,MODEL positive ints;
    anything else stops at the parser."""
    for bad in ("1x2", "0,2", "a,b", "2"):
        with pytest.raises(SystemExit):
            train.main(ARGS + ["--device", "cpu", "--mesh", bad])


def test_mesh_raises():
    # the production meshes need 256 / 512 ranks (torchrun); the sharded
    # body runs on a host mesh in tests/test_torch_sharded_train.py
    with pytest.raises(ValueError, match="needs 256 ranks"):
        train.main(ARGS + ["--device", "cpu", "--mesh", "pod"])
    with pytest.raises(ValueError, match="needs 512 ranks"):
        train.main(ARGS + ["--device", "cpu", "--mesh", "multipod"])


def _jax_params(cfg, params):
    """The port's per-layer tree → the reference's (one block-pattern
    position: every layer stacked in ``blocks[0]``)."""
    conv = lambda t: jnp.asarray(t.numpy())
    stacked = jax.tree.map(lambda *ls: jnp.stack([conv(x) for x in ls]),
                           *params["layers"])
    out = {k: jax.tree.map(conv, params[k])
           for k in ("embed", "final_norm", "head")}
    out["blocks"] = (stacked,)
    return out


def test_summary_lines_and_first_loss_match(monkeypatch, capsys, tmp_path):
    """The arch and BRDS lines the reference prints for the same flags,
    and step 0's loss: the reference's loss on the port's pruned initial
    weights and the same batch."""
    def stop(*a, **k):
        raise _Stop
    monkeypatch.setattr(repro.training, "make_train_step", stop)
    monkeypatch.setattr("sys.argv", ["train"] + ARGS +
                        ["--ckpt-dir", str(tmp_path / "jax")])
    with pytest.raises(_Stop):
        jtrain.main()
    want = capsys.readouterr().out.splitlines()
    out = train.main(ARGS + ["--steps", "1", "--device", "cpu",
                             "--ckpt-dir", str(tmp_path / "port")])
    got = capsys.readouterr().out.splitlines()
    assert got[:2] == want[:2]
    assert want[1].startswith("BRDS: {'prunable_params'")

    cfg = smoke_config("qwen3-0.6b")
    params = build_model(cfg).init(torch.Generator().manual_seed(0),
                                   device="cpu")
    params, _ = transformer_policy(0.75, 0.5).compile(params).prune(params)
    raw = ZipfInduction(vocab_size=cfg.vocab_size).batch(0, 4, 32)
    jm = jbuild_model(jsmoke_config("qwen3-0.6b"))
    jloss = jax.jit(jm.loss)(_jax_params(cfg, params),
                             {k: jnp.asarray(v) for k, v in raw.items()})
    np.testing.assert_allclose(out["losses"][0], float(jloss), rtol=1e-6)


def test_injected_failure_and_resume(tmp_path, capsys):
    """``--inject-failure-at 3`` after a checkpoint at 2: the run restores
    step 2 and replays steps 2-5; every loss is finite, the replayed step
    2 equals the first run of it, checkpoints 4 and 6 are kept, the
    pruned weights stay 0; a second run with more steps auto-resumes at
    6 from the saved (params, optimizer state)."""
    ck = str(tmp_path / "ck")
    out = train.main(ARGS + ["--device", "cpu", "--ckpt-dir", ck,
                             "--inject-failure-at", "3"])
    assert "injecting failure at step 3" in capsys.readouterr().out
    assert out["resumed_from"] == [2]
    assert out["final_step"] == 6
    assert sorted(out["losses"]) == list(range(6))
    assert all(np.isfinite(v) for v in out["losses"].values())
    assert CheckpointManager(ck).all_steps() == [4, 6]

    clean = train.main(ARGS + ["--device", "cpu", "--ckpt-dir",
                               str(tmp_path / "clean")])
    assert clean["losses"] == out["losses"]

    cfg = smoke_config("qwen3-0.6b")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    masks = transformer_policy(0.75, 0.5).compile(params).masks(params)
    from repro_torch.training import OptConfig, init_state
    template = (params, init_state(OptConfig(), params))
    (saved, opt), meta = CheckpointManager(ck).restore(template)
    assert meta["step"] == 6 and int(opt["count"]) == 6
    for path, m in masks.items():
        node = saved
        for k in path.split("/"):
            node = node[int(k)] if k.isdigit() else node[k]
        assert not node[~m].any(), path
    assert all(torch.isfinite(t).all() for t in leaves(saved))

    more = train.main(ARGS + ["--steps", "8", "--device", "cpu",
                              "--ckpt-dir", ck])
    assert "resumed from checkpoint at step 6" in capsys.readouterr().out
    assert more["resumed_from"] == [6] and sorted(more["losses"]) == [6, 7]
    assert os.path.isdir(os.path.join(ck, "step_00000008"))

"""Sharded training (``training.jit_train_step``, the shardings, ZeRO-1,
``CheckpointManager.restore(shardings=)`` / ``elastic_restore``,
``launch.train``'s sharded body, ``launch.pipeline``'s ``mesh=``) on gloo
CPU ranks, against the JAX reference's single-device ``make_train_step``
on the same inputs.

Meshes (data, model) = (1, 2), (2, 1) and (2, 2), on a small LSTM LM and
``smoke_config('llama3.2-3b')``: the loss within ``LOSS_RTOL``, every
gradient leaf within ``GRAD_ATOL`` of its largest entry, params after one
AdamW step within lr/100 everywhere and all but 0.1% of entries within
1e-6 (``tests/test_torch_training.py``'s rule), the loss and every leaf
bitwise alike on every rank, each rank's local pieces the shape its
shardings imply, pruned entries (and their moments) exactly 0 over masked
steps. The step is tensor-parallel: a rank's loss and gradient take
1 / (data · model) of one device's FLOPs. Where the model axis splits the
smoke llama's sums (its tensor-parallel meshes), the llama is held to the
rounding spread of its own one-device step (``TP_GRAD_ATOL``, measured by
``test_llama_smoke_rounding_spread``). A batch ``mask`` gives the whole
batch's masked mean. A checkpoint written on (2, 2) restores bitwise on
(1, 2) and on one device. ``launch.pipeline --smoke --mesh 1,2 --device cpu`` runs to
its end in a subprocess beside the ranks.

Each mesh's ranks start once (``launch.mesh.run_ranks``), all three at
the same time; the rank functions live here and import no JAX.
"""
import ast
import concurrent.futures
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import run_ranks

ROOT = Path(__file__).resolve().parents[1]
KW = dict(input_size=16, hidden=16, num_layers=2, vocab_size=64)
B, T = 4, 12
LR = 1e-2
OPT = dict(lr=LR, warmup_steps=1, total_steps=10)
STEP = 3                  # past the warmup: lr_at(3) > 0
LOSS_RTOL = 1e-6          # float32 losses, a mean of two means
GRAD_ATOL = 1e-6          # of each leaf's largest entry
# against the reference, of each leaf's largest entry: the smoke llama's
# scores reach ~100 (tests/test_torch_transformer.py), so the port's own
# one-device gradients sit 2.4e-5 of a leaf's max from the reference's
# (measured on this batch), and its params after AdamW steps up to ~5e-4;
# llama's sharded step is held to the strict rules against the port's
# one-device step, and to the reference within twice the one-device gap
REF_GRAD_ATOL = {"lstm": GRAD_ATOL, "llama": 5e-5}
PARAM_ATOL = LR / 100
PARAM_TIGHT, TIGHT_SHARE = 1e-6, 1e-3
# the smoke llama's one-device gradients move by more than this under
# 1e-7 relative perturbations of its params (the most of four, 4e-5 to
# 1.1e-4 of a leaf's max each, measured; test_llama_smoke_rounding_spread
# holds it), so a tensor-parallel order of its sums is held here, the LSTM
# to GRAD_ATOL
TP_GRAD_ATOL = REF_GRAD_ATOL["llama"]
# the smoke MoE's and RWKV6's gradients under the step against one
# device's where the model axis splits their params, of each leaf's
# largest entry: about twice the most three 1e-7 relative nudges of their
# params move their one-device gradients on this batch (3.4e-5 and
# 1.8e-5; the steps' gaps 9.8e-6 and 2.1e-6); GRAD_ATOL where it splits
# none
FAMILY_GRAD = {"granite-moe-1b-a400m": 7e-5, "rwkv6-7b": 4e-5}
PIPE_LOSS_ATOL = 2e-6     # train_lstm's losses, sharded against one device
PIPE_STEPS = 12
MESHES = [(1, 2), (2, 1), (2, 2)]
CKPT_STEP = 7
# positions 1..S-1 of the llama batch: a row with none, one with 3, two
# whole, so the data groups' counts differ (3 and 30)
MASK = np.ones((4, 15), np.float32)
MASK[0] = 0
MASK[1, 3:] = 0
TRAIN_ARGS = ["--arch", "llama3.2-3b", "--smoke", "--steps", "4", "--batch",
              "4", "--seq", "16", "--save-every", "2",
              "--inject-failure-at", "3", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ rank bodies

def _models():
    from repro_torch.configs import smoke_config
    from repro_torch.models import LSTMConfig, LSTMModel, build_model
    return {"lstm": LSTMModel(LSTMConfig("t", **KW)),
            "llama": build_model(smoke_config("llama3.2-3b"))}


def _port_params(name, model, tree):
    from repro_torch.models import (params_from_numpy,
                                    transformer_params_from_numpy)
    if name == "lstm":
        return params_from_numpy(tree, "cpu")
    return transformer_params_from_numpy(model.cfg, tree, "cpu")


def _policy(name):
    from repro_torch.sparse import lstm_policy, transformer_policy
    return (lstm_policy(0.75, 0.5) if name == "lstm"
            else transformer_policy(0.75, 0.5))


def _whole(tree):
    from repro_torch.dist.collective_ops import full_tensor
    from repro_torch.training.tree import leaves
    return [full_tensor(x).detach().numpy().copy() for x in leaves(tree)]


def _local_shapes(tree):
    from repro_torch.training.tree import leaves
    return [tuple(x.to_local().shape) for x in leaves(tree)]


def _expected_shapes(mesh, shardings, defs):
    """The local shape each NamedSharding implies on ``mesh``."""
    from repro_torch.training.tree import leaves
    out = []
    for sh, d in zip(leaves(shardings), leaves(defs)):
        shape = list(d.shape)
        for i, pl in enumerate(sh.placements):
            if pl.is_shard():
                shape[pl.dim] //= mesh.size(i)
        out.append(tuple(shape))
    return out


def _mask_leaves(model, masks):
    """The masks as a list aligned with the params' leaves (None where a
    leaf is not pruned)."""
    from repro_torch.sparse.policy import _map_with_path
    from repro_torch.training.tree import leaves
    paths = leaves(_map_with_path(model.param_defs(), lambda ps, _: ps))
    return [None if ps not in masks else masks[ps].numpy() for ps in paths]


def _train_rank(mesh, trees, batches, ckpt_dir, pipe_dir):
    """Every training scenario of one mesh (see the module docstring)."""
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch import mesh as M
    from repro_torch.launch import train as train_cli
    from repro_torch.training import (CheckpointManager, OptConfig,
                                      elastic_restore, init_state,
                                      jit_train_step)
    from repro_torch.obs.collectives import inventory
    from repro_torch.training.train_loop import (opt_shardings,
                                                 param_shardings)
    from repro_torch.training.tree import leaves
    shape = tuple(mesh.shape)
    out = {"rank": dist.get_rank()}
    oc = OptConfig(**OPT)
    for name, model in _models().items():
        arch = types.SimpleNamespace(grad_accum=1, zero1=True)
        params = _port_params(name, model, trees[name])
        batch = {k: torch.as_tensor(v) for k, v in batches[name].items()}
        step = jit_train_step(mesh, model, arch, oc, batch)
        with FlopCounterMode(display=False) as flops:
            loss, grads = step.grads(params, batch)
        # the step's aten FLOPs and, in a second step, its collectives as
        # gloo ran them (the dry run's trace of the step is held to them;
        # a dispatch mode under the profiler records each c10d op twice)
        with FlopCounterMode(display=False) as step_flops:
            p1, o1, met = step(params, init_state(oc, params), batch, STEP)
        items = inventory(step, params, init_state(oc, params), batch, STEP)
        p_sh = param_shardings(mesh, model)
        o_sh = opt_shardings(mesh, oc, p_sh, model.param_defs())
        defs = model.param_defs()
        res = dict(
            loss=float(loss), step_loss=float(met["loss"]),
            grad_norm=float(met["grad_norm"]), grads=_whole(grads),
            params=_whole(p1),
            shapes=_local_shapes(p1) == _expected_shapes(mesh, p_sh, defs),
            m_shapes=_local_shapes(o1["m"]) == _expected_shapes(
                mesh, o_sh["m"], defs),
            v_shapes=_local_shapes(o1["v"]) == _expected_shapes(
                mesh, o_sh["v"], defs), flops=flops.get_total_flops(),
            step_flops=step_flops.get_total_flops(),
            colls=[(it["kind"], it["bytes"]) for it in items],
            held=sum(x.to_local().nbytes for x in leaves((p1, o1))))
        if name == "llama":
            mb = dict(batch, mask=torch.as_tensor(MASK))
            ml, mg = jit_train_step(mesh, model, arch, oc, mb).grads(params,
                                                                     mb)
            res["mask_loss"], res["mask_grads"] = float(ml), _whole(mg)
        # masked retraining: two steps, pruned entries and moments exactly 0
        pruned, masks = _policy(name).compile(params).prune(params)
        mstep = jit_train_step(mesh, model, arch, oc, batch, masks)
        pm, om = pruned, init_state(oc, pruned)
        for s in (STEP, STEP + 1):
            pm, om, _ = mstep(pm, om, batch, s)
        res["masked"] = dict(params=_whole(pm), m=_whole(om["m"]),
                             v=_whole(om["v"]), masks=_mask_leaves(
                                 model, masks))
        if name == "lstm" and shape == (2, 2):
            ckpt = CheckpointManager(ckpt_dir, async_save=False)
            ckpt.save(CKPT_STEP, (pm, om))
            res["saved"] = _whole((pm, om))
        out[name] = res
    if shape == (1, 2):
        out["restored"] = _restore_when_written(mesh, ckpt_dir, oc)
        out["pipeline"] = _pipeline_losses(mesh)
        args = train_cli.parser().parse_args(TRAIN_ARGS)
        run = train_cli._train(args, pipe_dir, mesh)
        out["train_cli"] = {k: run[k] for k in ("losses", "resumed_from",
                                                "final_step")}
        out["init_sharded"] = _init_and_prune_sharded(mesh, oc)
        out["tempdir"] = train_cli._shared_tempdir(mesh)
        out["agreed"] = train_cli._agreed_step(mesh, 4)
        try:
            train_cli._agreed_step(mesh, 2 if dist.get_rank() else None)
        except RuntimeError as e:
            out["disagreed"] = str(e)
    out["families"] = _other_families(mesh, oc)
    try:
        M.make_production_mesh()
    except ValueError as e:
        out["production"] = str(e)
    return out


def _other_families(mesh, oc):
    """The MoE and RWKV6 under the step on every mesh: their loss and
    gradients against one device's, and whether the model axis splits
    their params."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import build_model
    from repro_torch.training import jit_train_step
    from repro_torch.training.train_loop import (param_shardings,
                                                 value_and_grad)
    from repro_torch.training.tree import leaves
    arch = types.SimpleNamespace(grad_accum=1, zero1=True)
    m = list(mesh.mesh_dim_names).index("model")
    out = {}
    raw = np.random.default_rng(2).integers(0, 512, (4, 8))
    batch = {"tokens": torch.as_tensor(raw), "labels": torch.as_tensor(raw)}
    for name in FAMILY_GRAD:
        model = build_model(smoke_config(name))
        step = jit_train_step(mesh, model, arch, oc, batch)
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        loss, grads = step.grads(params, batch)
        l1, g1 = value_and_grad(model.loss, params, batch)
        # does the model axis split any of its params?
        split = mesh.size(m) > 1 and any(
            sh.placements[m].is_shard()
            for sh in leaves(param_shardings(mesh, model)))
        out[name] = dict(loss=(float(loss), float(l1)), split=split,
                         grad=max(
                             float(np.abs(a - b.numpy()).max() / max(
                                 float(b.abs().max()), 1e-30))
                             for a, b in zip(_whole(grads), leaves(g1))))
    return out


def _init_and_prune_sharded(mesh, oc):
    """``init_sharded`` and ``prune_sharded`` (``launch.train --mesh``'s
    start) against ``model.init`` and ``plan.prune`` of the whole tree."""
    from repro_torch.sparse import transformer_policy
    from repro_torch.training.train_loop import (init_sharded,
                                                 opt_shardings,
                                                 param_shardings,
                                                 prune_sharded)
    from repro_torch.training.tree import leaves
    model = _models()["llama"]
    params, state = init_sharded(mesh, model, oc,
                                 torch.Generator().manual_seed(0), "cpu")
    whole = model.init(torch.Generator().manual_seed(0), device="cpu")
    plan = transformer_policy(0.75, 0.5).compile(params)
    pruned, masks, report = prune_sharded(plan, params)
    wplan = transformer_policy(0.75, 0.5).compile(whole)
    wpruned, wmasks = wplan.prune(whole)
    p_sh = param_shardings(mesh, model)
    o_sh = opt_shardings(mesh, oc, p_sh, model.param_defs())
    defs = model.param_defs()
    return dict(
        init=all(np.array_equal(a, b.numpy())
                 for a, b in zip(_whole(params), leaves(whole))),
        pruned=all(np.array_equal(a, b.numpy())
                   for a, b in zip(_whole(pruned), leaves(wpruned))),
        masks=sorted(masks) == sorted(wmasks) and all(
            np.array_equal(_whole([masks[k]])[0], wmasks[k].numpy())
            for k in wmasks),
        report=report == wplan.summary(wmasks),
        shapes=_local_shapes(params) == _expected_shapes(mesh, p_sh, defs)
        and _local_shapes(state["m"]) == _expected_shapes(mesh, o_sh["m"],
                                                          defs),
        zeros=not any(bool(x.to_local().any()) for x in leaves(state)))


def _restore_when_written(mesh, ckpt_dir, oc):
    """The (2, 2) ranks' checkpoint, once committed, re-sharded onto this
    mesh by ``elastic_restore``."""
    import time
    from repro_torch.training import (CheckpointManager, elastic_restore,
                                      init_state)
    from repro_torch.training.train_loop import (opt_shardings,
                                                 param_shardings)
    model = _models()["lstm"]
    deadline = time.monotonic() + 240
    ckpt = CheckpointManager(ckpt_dir, async_save=False)
    while ckpt.latest_step() != CKPT_STEP:
        if time.monotonic() > deadline:
            raise TimeoutError("the (2, 2) ranks wrote no checkpoint")
        time.sleep(0.2)
    params = model.init(device="cpu")
    p_sh = param_shardings(mesh, model)
    o_sh = opt_shardings(mesh, oc, p_sh, model.param_defs())
    (p, o), meta = elastic_restore(ckpt, (params, init_state(oc, params)),
                                   (p_sh, o_sh))
    from torch.distributed.tensor import DTensor
    from repro_torch.training.tree import leaves
    return dict(values=_whole((p, o)), step=meta["step"],
                dtensors=all(isinstance(x, DTensor)
                             for x in leaves((p, o))),
                shapes=_local_shapes(p) == _expected_shapes(
                    mesh, p_sh, model.param_defs()))


def _pipeline_losses(mesh):
    """``train_lstm(mesh=)`` on the smoke pipeline's task, every step's
    loss."""
    from repro_torch.launch import pipeline as pl
    from repro_torch.models import LSTMModel
    cfg = pl.PipelineConfig(device="cpu")
    corpus, lcfg = pl.build_task(cfg)
    losses = []
    pl.train_lstm(LSTMModel(lcfg), corpus, cfg, steps=PIPE_STEPS, lr=cfg.lr,
                  mesh=mesh, losses=losses)
    return losses


# ---------------------------------------------------------------- fixture

def _one_device(trees, batches):
    """The port's one-device math on the same inputs: loss and gradients
    (and their FLOPs), one AdamW step, two masked steps (whole leaves,
    numpy); the llama's under the batch mask, and the spread of its
    gradients under a 1e-7 relative perturbation of its params."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.training import OptConfig, init_state, make_train_step
    from repro_torch.training.train_loop import value_and_grad
    from repro_torch.training.tree import leaves, unflatten
    oc, arch = OptConfig(**OPT), types.SimpleNamespace(grad_accum=1)
    out = {}
    for name, model in _models().items():
        params = _port_params(name, model, trees[name])
        batch = {k: torch.as_tensor(v) for k, v in batches[name].items()}
        with FlopCounterMode(display=False) as flops:
            loss, grads = value_and_grad(model.loss, params, batch)
        p1, _, _ = make_train_step(model, arch, oc)(
            params, init_state(oc, params), batch, STEP)
        pm, masks = _policy(name).compile(params).prune(params)
        om = init_state(oc, pm)
        step = make_train_step(model, arch, oc, masks)
        for s in (STEP, STEP + 1):
            pm, om, _ = step(pm, om, batch, s)
        out[name] = dict(loss=float(loss),
                         grads=[x.numpy() for x in leaves(grads)],
                         params=[x.numpy() for x in leaves(p1)],
                         masked=[x.numpy() for x in leaves(pm)],
                         flops=flops.get_total_flops())
        if name == "llama":
            ml, mg = value_and_grad(model.loss, params,
                                    dict(batch, mask=torch.as_tensor(MASK)))
            spread = 0.0
            for seed in range(4):
                gen = torch.Generator().manual_seed(seed)
                nudged = [x * (1 + 1e-7 * torch.randn(x.shape,
                                                      generator=gen))
                          for x in leaves(params)]
                _, ng = value_and_grad(model.loss,
                                       unflatten(params, nudged), batch)
                spread = max([spread] + [
                    float((a - b).abs().max() / b.abs().max())
                    for a, b in zip(leaves(ng), leaves(grads))])
            out[name].update(
                mask_loss=float(ml), mask_grads=[x.numpy()
                                                 for x in leaves(mg)],
                spread=spread)
    return out


def _np_tree(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's loss, gradients and steps on one device, and every
    mesh's rank results (the three meshes and the pipeline CLI at once)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import smoke_config as jsmoke
    from repro.models import LSTMConfig as JConfig, LSTMModel as JModel
    from repro.models import build_model as jbuild
    from repro.sparse import lstm_policy as jlstm_policy
    from repro.sparse import transformer_policy as jtransformer_policy
    from repro.training import OptConfig as JOpt, init_state as jinit
    from repro.training import make_train_step as jmake
    from repro_torch.training import data
    tmp = tmp_path_factory.mktemp("sharded")
    jmodels = {"lstm": JModel(JConfig("t", **KW)),
               "llama": jbuild(jsmoke("llama3.2-3b"))}
    jparams = {k: m.init(jax.random.key(0)) for k, m in jmodels.items()}
    trees = {k: _np_tree(v) for k, v in jparams.items()}
    raw = data.ZipfInduction(vocab_size=KW["vocab_size"]).batch(0, B, T)
    traw = data.ZipfInduction(vocab_size=512).batch(0, B, 16)
    batches = {"lstm": {"inputs": raw["tokens"], "labels": raw["labels"]},
               "llama": {"tokens": traw["tokens"],
                         "labels": traw["labels"]}}
    pipe = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.pipeline", "--smoke",
         "--mesh", "1,2", "--device", "cpu", "--out", str(tmp / "bench")],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    with concurrent.futures.ThreadPoolExecutor(len(MESHES)) as pool:
        futs = {m: pool.submit(run_ranks, _train_rank, *m,
                               args=(trees, batches, str(tmp / "ckpt"),
                                     str(tmp / f"train{m[0]}{m[1]}")))
                for m in MESHES}
        ref = {}
        kw = dict(OPT)
        for name, jm in jmodels.items():
            jp = jparams[name]
            jb = {k: jnp.asarray(v) for k, v in batches[name].items()}
            arch = types.SimpleNamespace(grad_accum=1)
            jl, jg = jax.jit(jax.value_and_grad(jm.loss))(jp, jb)
            jp1, _, jmet = jax.jit(jmake(jm, arch, JOpt(**kw)))(
                jp, jinit(JOpt(**kw), jp), jb, jnp.int32(STEP))
            pol = (jlstm_policy(0.75, 0.5) if name == "lstm"
                   else jtransformer_policy(0.75, 0.5))
            pruned, masks = pol.compile(jp).prune(jp)
            mstep = jax.jit(jmake(jm, arch, JOpt(**kw), masks))
            pm, om = pruned, jinit(JOpt(**kw), pruned)
            for s in (STEP, STEP + 1):
                pm, om, _ = mstep(pm, om, jb, jnp.int32(s))
            ref[name] = dict(loss=float(jl), grads=_np_tree(jg),
                             step_loss=float(jmet["loss"]),
                             grad_norm=float(jmet["grad_norm"]),
                             params=_np_tree(jp1), masked=_np_tree(pm))
            if name == "llama":
                ml, mg = jax.jit(jax.value_and_grad(jm.loss))(
                    jp, dict(jb, mask=jnp.asarray(MASK)))
                ref[name].update(mask_loss=float(ml),
                                 mask_grads=_np_tree(mg))
        one = _one_device(trees, batches)
        out = {m: f.result() for m, f in futs.items()}
    text, _ = pipe.communicate(timeout=600)
    return dict(ref=ref, one=one, ranks=out, trees=trees,
                pipe=(pipe.returncode, text), tmp=tmp)


# ------------------------------------------------------------------ tests

def _port_leaves(runs, name, key):
    """The reference's ``key`` tree as the port's leaves (numpy)."""
    from repro_torch.training.tree import leaves
    model = _models()[name]
    tree = _port_params(name, model, runs["ref"][name][key])
    return [x.float().numpy() for x in leaves(tree)]


@pytest.mark.parametrize("name", ["lstm", "llama"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_loss_and_grads_match_reference(runs, mesh, name):
    """The sharded step's loss and every gradient leaf against the
    reference's ``jax.value_and_grad`` on one device."""
    want = runs["ref"][name]
    for rk in runs["ranks"][mesh]:
        got = rk[name]
        np.testing.assert_allclose(got["loss"], want["loss"],
                                   rtol=LOSS_RTOL)
        for g, w in zip(got["grads"], _port_leaves(runs, name, "grads")):
            scale = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(g - w).max()) <= REF_GRAD_ATOL[name] * scale


def _one_device_atol(name, mesh):
    """GRAD_ATOL, or the smoke llama's rounding spread where the model
    axis splits its sums."""
    return TP_GRAD_ATOL if name == "llama" and mesh[1] > 1 else GRAD_ATOL


@pytest.mark.parametrize("name", ["lstm", "llama"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_grads_match_one_device(runs, mesh, name):
    """The sharded loss and gradients against the port's own one-device
    step (``value_and_grad`` on the whole batch)."""
    want = runs["one"][name]
    atol = _one_device_atol(name, mesh)
    for rk in runs["ranks"][mesh]:
        got = rk[name]
        np.testing.assert_allclose(got["loss"], want["loss"],
                                   rtol=LOSS_RTOL)
        for g, w in zip(got["grads"], want["grads"]):
            scale = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(g - w).max()) <= atol * scale


def test_llama_smoke_rounding_spread(runs):
    """The smoke llama's one-device gradients move by at least
    ``TP_GRAD_ATOL`` of a leaf's max under one of four 1e-7 relative
    perturbations of its params: a different order of its sums is as
    far."""
    assert runs["one"]["llama"]["spread"] >= TP_GRAD_ATOL


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_tensor_parallel_flops(runs, mesh):
    """A rank's loss and gradient take 1 / (data · model) of one device's
    FLOPs (within 1%): the model axis splits the work, not only the
    storage."""
    for name in ("lstm", "llama"):
        want = runs["one"][name]["flops"] / (mesh[0] * mesh[1])
        for rk in runs["ranks"][mesh]:
            assert abs(rk[name]["flops"] - want) <= 0.01 * want, (
                name, rk[name]["flops"], want)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_dry_run_trace_matches_a_gloo_rank(runs, mesh):
    """``launch.dryrun.trace_step``, the same step as rank 0 of a fake
    group on fake tensors: its aten FLOPs, the param and moment bytes the
    rank holds, and its collectives (kind and bytes, in issue order) equal
    to what gloo rank 0 measured (FlopCounterMode, its pieces,
    torch.profiler's gloo events)."""
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    rank0 = runs["ranks"][mesh][0]
    try:
        fake = dryrun._mesh(False, mesh)
        for name, model in _models().items():
            S = T if name == "lstm" else 16
            tr = dryrun.trace_step(fake, model.cfg, model,
                                   ShapeConfig("t", S, B, "train"))
            want = rank0[name]
            assert tr["aten_flops"] == want["step_flops"], name
            held = tr["held"]
            assert held["params"] + held["moments"] + held["count"] == \
                want["held"], name
            assert [(r["kind"], r["bytes"]) for r in tr["collectives"]] == \
                want["colls"], name
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_masked_batch_loss_is_the_global_mean(runs, mesh):
    """Under a batch ``mask`` whose data groups hold 3 and 30 positions,
    the sharded loss is the whole batch's masked mean and its gradients
    the one-device ones (and the reference's)."""
    one, ref = runs["one"]["llama"], runs["ref"]["llama"]
    atol = _one_device_atol("llama", mesh)
    for rk in runs["ranks"][mesh]:
        got = rk["llama"]
        np.testing.assert_allclose(got["mask_loss"], one["mask_loss"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["mask_loss"], ref["mask_loss"],
                                   rtol=LOSS_RTOL)
        for g, w in zip(got["mask_grads"], one["mask_grads"]):
            scale = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(g - w).max()) <= atol * scale
        for g, w in zip(got["mask_grads"],
                        _port_leaves(runs, "llama", "mask_grads")):
            scale = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(g - w).max()) <= REF_GRAD_ATOL["llama"] * scale


def _params_close(got, want):
    """lr/100 everywhere, all but 0.1% of entries within 1e-6."""
    d = np.concatenate([np.abs(g - w).ravel() for g, w in zip(got, want)])
    assert float(d.max()) <= PARAM_ATOL, float(d.max())
    assert (d > PARAM_TIGHT).mean() <= TIGHT_SHARE


def _llama_gap(runs, key):
    """The largest distance of the port's one-device llama params
    (``key``) from the reference's."""
    ref = _port_leaves(runs, "llama", key)
    return max(float(np.abs(o - r).max())
               for o, r in zip(runs["one"]["llama"][key], ref))


def _params_vs_reference(runs, name, got, key):
    """``got`` against the reference's ``key`` params: the strict rule
    for the LSTM; for llama within twice the port's one-device gap (and
    lr/100)."""
    ref = _port_leaves(runs, name, key)
    if name == "lstm":
        return _params_close(got, ref)
    gap = _llama_gap(runs, key)
    d = max(float(np.abs(g - r).max()) for g, r in zip(got, ref))
    assert d <= max(PARAM_ATOL, 2 * gap), (d, gap)


def _params_vs_one_device(runs, name, mesh, got, key):
    """``got`` against the port's one-device ``key`` params: the strict
    rule, or, for the smoke llama where the model axis splits its sums
    (AdamW moves an entry whose gradient's sign is rounding by up to lr),
    the reference rule: twice the one-device gap from the reference."""
    want = runs["one"][name][key]
    if name == "llama" and mesh[1] > 1:
        d = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
        gap = _llama_gap(runs, key)
        assert d <= max(PARAM_ATOL, 2 * gap), (d, gap)
        return
    _params_close(got, want)


@pytest.mark.parametrize("name", ["lstm", "llama"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_step_matches_reference(runs, mesh, name):
    """One AdamW step: loss and grad norm, and params within lr/100
    everywhere and all but 0.1% of entries within 1e-6."""
    want = runs["ref"][name]
    got = runs["ranks"][mesh][0][name]
    np.testing.assert_allclose(got["step_loss"], want["step_loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=1e-5)
    _params_vs_one_device(runs, name, mesh, got["params"], "params")
    _params_vs_reference(runs, name, got["params"], "params")


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_ranks_agree_bitwise_and_local_shapes(runs, mesh):
    """The loss, every gradient, param and moment bitwise alike on every
    rank (a replicated leaf's copies too: each rank's whole is its own
    copy there), and each rank's pieces the shape its shardings imply."""
    ranks = runs["ranks"][mesh]
    for name in ("lstm", "llama"):
        first = ranks[0][name]
        for rk in ranks:
            got = rk[name]
            assert got["loss"] == first["loss"]
            assert got["step_loss"] == first["step_loss"]
            for key in ("grads", "params"):
                for a, b in zip(got[key], first[key]):
                    assert np.array_equal(a, b)
            for key in ("params", "m", "v"):
                for a, b in zip(got["masked"][key], first["masked"][key]):
                    assert np.array_equal(a, b)
            assert got["shapes"] and got["m_shapes"] and got["v_shapes"]


@pytest.mark.parametrize("name", ["lstm", "llama"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_masked_steps_keep_pruned_zero(runs, mesh, name):
    """Two masked steps: every pruned entry of the params and of both
    moments exactly 0, and the params within lr/100 of the reference's
    two masked steps."""
    got = runs["ranks"][mesh][0][name]["masked"]
    pruned = 0
    for i, mk in enumerate(got["masks"]):
        if mk is None:
            continue
        for key in ("params", "m", "v"):
            assert not got[key][i][~mk].any(), (i, key)
        pruned += int((~mk).sum())
    assert pruned > 0
    _params_vs_one_device(runs, name, mesh, got["params"], "masked")
    _params_vs_reference(runs, name, got["params"], "masked")


def test_elastic_restore_bitwise(runs):
    """The (2, 2) ranks' checkpoint restores bitwise on (1, 2)
    (``elastic_restore``, DTensors of the new layout) and on one device,
    with its step."""
    from repro_torch.models import LSTMModel, LSTMConfig
    from repro_torch.training import CheckpointManager, OptConfig, \
        init_state
    from repro_torch.training.tree import leaves
    saved = runs["ranks"][(2, 2)][0]["lstm"]["saved"]
    for rk in runs["ranks"][(1, 2)]:
        got = rk["restored"]
        assert got["step"] == CKPT_STEP and got["dtensors"]
        assert got["shapes"]
        for a, b in zip(got["values"], saved):
            assert np.array_equal(a, b)
    ckpt = CheckpointManager(str(runs["tmp"] / "ckpt"), async_save=False)
    params = LSTMModel(LSTMConfig("t", **KW)).init(device="cpu")
    oc = OptConfig(**OPT)
    (p, o), meta = ckpt.restore((params, init_state(oc, params)))
    assert meta["step"] == CKPT_STEP
    for a, b in zip(leaves((p, o)), saved):
        assert np.array_equal(a.numpy(), b)


def test_train_lstm_mesh_losses(runs):
    """``pipeline.train_lstm(mesh=)`` on the smoke task: every step's loss
    within ``PIPE_LOSS_ATOL`` of one device's over the same steps."""
    from repro_torch.launch import pipeline as pl
    from repro_torch.models import LSTMModel
    cfg = pl.PipelineConfig(device="cpu")
    corpus, lcfg = pl.build_task(cfg)
    want = []
    pl.train_lstm(LSTMModel(lcfg), corpus, cfg, steps=PIPE_STEPS, lr=cfg.lr,
                  losses=want)
    for rk in runs["ranks"][(1, 2)]:
        got = rk["pipeline"]
        assert len(got) == PIPE_STEPS
        np.testing.assert_allclose(got, want, rtol=0, atol=PIPE_LOSS_ATOL)


def test_pipeline_cli_mesh_runs_to_the_end(runs):
    """``launch.pipeline --smoke --mesh 1,2 --device cpu``: exit 0, the
    sharded training announced, parity bitwise at every grid point, the
    quality gate passed."""
    rc, text = runs["pipe"]
    assert rc == 0, text[-3000:]
    assert "mesh: data=1 model=2 over 2 ranks, gloo" in text
    assert "serving parity bitwise at every one" in text
    assert "quality gate OK" in text


def test_launch_train_sharded_body(tmp_path, runs):
    """``launch.train``'s body over a (1, 2) host mesh (the path of
    ``--mesh pod``): the losses within ``LOSS_RTOL`` of one device's,
    the failure at step 3 restored from the step-2 checkpoint
    (``restore(shardings=)``)."""
    from repro_torch.launch import train as train_cli
    args = train_cli.parser().parse_args(TRAIN_ARGS)
    want = train_cli._train(args, str(tmp_path))
    for rk in runs["ranks"][(1, 2)]:
        got = rk["train_cli"]
        assert got["resumed_from"] == want["resumed_from"] == [2]
        assert got["final_step"] == want["final_step"] == 4
        assert sorted(got["losses"]) == sorted(want["losses"])
        for s, l in want["losses"].items():
            np.testing.assert_allclose(got["losses"][s], l, rtol=LOSS_RTOL)


def test_init_and_prune_sharded(runs):
    """``init_sharded`` draws the values ``model.init`` draws, each rank
    keeping its pieces (moments zero pieces of ZeRO-1's layout), and
    ``prune_sharded`` gives ``plan.prune``'s params, masks and report."""
    for rk in runs["ranks"][(1, 2)]:
        assert rk["init_sharded"] == dict(init=True, pruned=True, masks=True,
                                          report=True, shapes=True,
                                          zeros=True)


def test_launch_train_ranks_agree_on_resume(runs):
    """``launch.train`` under a mesh: the ranks of one host share rank
    0's temporary checkpoint directory, and ranks that resumed different
    steps stop rather than fall out of step."""
    import shutil
    ranks = runs["ranks"][(1, 2)]
    assert ranks[0]["tempdir"] == ranks[1]["tempdir"]
    shutil.rmtree(ranks[0]["tempdir"], ignore_errors=True)
    for rk in ranks:
        assert rk["agreed"] == 4
        assert "resumed from different steps (-1 to 2;" in rk["disagreed"]


def test_other_families_under_the_step(runs):
    """The MoE and RWKV6 train under the step on every mesh: their loss
    and gradients those of one device, within each one's rounding spread
    (``FAMILY_GRAD``) where the model axis splits their params, else
    within GRAD_ATOL (tests/test_torch_tp_train_zoo.py holds every family
    against the reference)."""
    for mesh, ranks in runs["ranks"].items():
        for rk in ranks:
            fam = rk["families"]
            for name, tol in FAMILY_GRAD.items():
                got, want = fam[name]["loss"]
                np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
                if not fam[name]["split"]:
                    tol = GRAD_ATOL
                assert fam[name]["grad"] <= tol, (mesh, name,
                                                  fam[name]["grad"])


def test_production_mesh_names_its_ranks(runs):
    """On a group of 2 or 4 ranks the production mesh names the 256 it
    needs."""
    for mesh, ranks in runs["ranks"].items():
        for rk in ranks:
            assert "needs 256 ranks" in rk["production"]
            assert f"has {mesh[0] * mesh[1]}" in rk["production"]


def test_training_exports_cover_reference():
    """``repro_torch.training.__all__`` covers every name the reference's
    ``repro/training/__init__.py`` exports."""
    import repro_torch.training as T
    tree = ast.parse((ROOT / "src/repro/training/__init__.py").read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
    assert names, "no exports read"
    assert names <= set(T.__all__), sorted(names - set(T.__all__))
    for n in names:
        assert hasattr(T, n), n

"""Tensor-parallel training of every zoo family (``training.jit_train_step``
over ``with_mesh``' forms, ``TensorParallel.cross_entropy``) on gloo CPU
ranks at meshes (1, 2) and (2, 2), against the JAX reference's
one-device ``value_and_grad`` and the port's one-device step on the same
numpy inputs.

The smoke configs of granite-moe-1b-a400m and qwen3-moe-235b-a22b (experts
over ``model``; granite-moe's "dp" layout set to "tp", as the dry run sets
it where the batch does not cover every rank), recurrentgemma-9b (the
RG-LRU on a rank's ``d_rnn`` columns, MQA local attention),
rwkv6-7b (a rank's heads), seamless-m4t-medium (its ``wq`` / ``wk``
scaled by 1/4, as ``tests/test_torch_encdec.py`` holds it; "tp" layout)
and llava-next-34b (4 real q heads stored as 64, patch embeddings): the
sharded step's loss and every gradient leaf within each family's
tolerance of the reference (``REF_GRAD``, its one-device tests'
tolerances) and of the port's one-device step (``SELF_GRAD``: each
family's own rounding spread, the most a 1e-7 relative nudge of its
params moves its one-device gradients, measured on this batch); the loss
and the gradients bitwise alike on every rank; MoE expert ids, ranks and
drop sets exact. The batch's mask zeroes the rows of the first data group
at (2, 2), so the MoE's load-balancing term is held to the whole batch's
there.

The gradient faults of the serving forms, each held at the form: the
RG-LRU gates' backward (each rank's rows feed every rank's columns) and
the expert-parallel router and load-balancing term (the combine weights
of every rank's experts reach every router column; the term every rank
computes alike counted once). The vocab-parallel cross-entropy against
``core.metrics.cross_entropy`` of the whole logits: pad columns on the
last rank, labels on every rank's columns, a mask with an all-zero row
group, an all-zero mask; no tensor as wide as the padded vocabulary is
made. ``launch.train --mesh 1,2 --smoke`` on one MoE and one recurrent
arch, end to end in a subprocess.

Each mesh's ranks start once, both at the same time, beside the CLI
subprocesses; the rank functions live here and import no JAX.
"""
import concurrent.futures
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import run_ranks

ROOT = Path(__file__).resolve().parents[1]
MOE = ("granite-moe-1b-a400m", "qwen3-moe-235b-a22b")
REC = ("recurrentgemma-9b", "rwkv6-7b")
ENCDEC, VLM = "seamless-m4t-medium", "llava-next-34b"
ARCHS = MOE + REC + (ENCDEC, VLM)
MESHES = [(1, 2), (2, 2)]
B, S, FRAMES = 4, 16, 8
TEMPER = 0.25                 # seamless-m4t's wq, wk scale
LOSS_RTOL = 2e-6
# every gradient leaf against the reference, of its largest entry: the
# one-device tests' tolerances (tests/test_torch_moe.py, _recurrent.py,
# _encdec.py, _zoo.py)
REF_GRAD = {"granite-moe-1b-a400m": 2e-3, "qwen3-moe-235b-a22b": 1e-4,
            "recurrentgemma-9b": 2e-3, "rwkv6-7b": 1e-4,
            "seamless-m4t-medium": 1e-4, "llava-next-34b": 1e-4}
# against the port's one-device gradients, of each leaf's largest entry:
# about twice each family's rounding spread on this batch, the most three
# 1e-7 relative nudges of its params moved any leaf of its one-device
# gradients (measured 3.1e-4, 1.7e-6, 1.1e-4, 2.7e-5, 6.3e-6, 1.7e-5;
# the sharded steps' gaps 2.5e-5, 1.6e-6, 1.1e-4, 7.1e-6, 2.7e-6, 2.5e-6)
SELF_GRAD = {"granite-moe-1b-a400m": 6e-4, "qwen3-moe-235b-a22b": 4e-6,
             "recurrentgemma-9b": 2e-4, "rwkv6-7b": 5e-5,
             "seamless-m4t-medium": 1.2e-5, "llava-next-34b": 3e-5}
SELF_LOSS_RTOL = 1e-6
# the mask over positions 1..S-1: the first data group's rows (at (2, 2))
# all zero, one row partly live
MASK = np.ones((B, S - 1), np.float32)
MASK[:2] = 0
MASK[2, 5:] = 0
# the forms alone
FORM_RTOL = 1e-5              # measured 1.5e-7 to 5e-7
CE_LOSS_RTOL, CE_GRAD = 1e-6, 2e-7   # measured 0 and 1.2e-7
CE_VOCAB, CE_PADDED = 300, 512
TRAIN_ARGS = ["--smoke", "--device", "cpu", "--steps", "2", "--batch", "4",
              "--seq", "16"]
CLI_ARCHS = ("qwen3-moe-235b-a22b", "recurrentgemma-9b")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ rank bodies

def _cfg(arch):
    from repro_torch.configs import smoke_config
    return smoke_config(arch).with_(layout="tp")


def _port_params(cfg, tree):
    from repro_torch.models import (encdec_params_from_numpy,
                                    transformer_params_from_numpy)
    conv = (encdec_params_from_numpy if cfg.encdec
            else transformer_params_from_numpy)
    return conv(cfg, tree, "cpu")


def _batch(cfg):
    """Tokens (the labels too), the mask and the config's conditioning,
    as numpy arrays from a seed."""
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    out = {"tokens": toks, "labels": toks, "mask": MASK}
    if cfg.encdec:
        out["frames"] = rng.normal(size=(B, FRAMES, cfg.d_model)).astype(
            np.float32)
    if cfg.num_patches:
        out["patch_embeds"] = rng.normal(
            size=(B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return out


def _torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


class _Routes:
    """Records ``moe.route``'s ids and each pair's rank within its expert
    (the drop set: rank >= C) of every call while on."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.real, self.seen = moe, moe.route, []

    def __enter__(self):
        def route(*a, **kw):
            out = self.real(*a, **kw)
            self.seen.append((out[0].numpy().copy(), out[2].numpy().copy(),
                              out[3]))
            return out
        self.moe.route = route
        return self.seen

    def __exit__(self, *exc):
        self.moe.route = self.real


def _whole(tree):
    from repro_torch.dist.collective_ops import full_tensor
    from repro_torch.training.tree import leaves
    return [full_tensor(x).detach().numpy().copy() for x in leaves(tree)]


def _pieces(mesh, model, whole):
    """Each leaf's piece of ``whole`` (plain tensors) under the rule
    table, as leaves requiring grad, and the DTensors over them."""
    from repro_torch.dist.collective_ops import shard_local, to_dtensor
    from repro_torch.training.train_loop import param_shardings
    from repro_torch.training.tree import leaves, unflatten
    sh = leaves(param_shardings(mesh, model))
    flat = [shard_local(x, mesh, s.placements).detach().requires_grad_(True)
            for x, s in zip(leaves(whole), sh)]
    tree = unflatten(whole, [to_dtensor(x, mesh, s.placements, w.shape)
                             for x, s, w in zip(flat, sh, leaves(whole))])
    return flat, tree, sh


def _gather_whole(mesh, g, sh):
    """A gradient piece gathered whole over the mesh dims ``sh`` splits."""
    from repro_torch.dist.collective_ops import gather_axis
    names = list(mesh.mesh_dim_names)
    for i in reversed(range(len(names))):
        if sh.placements[i].is_shard():
            g = gather_axis(g, mesh, names[i], sh.placements[i].dim)
    return g


def _rel(a, b) -> float:
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


def _form_grads(mesh, model, whole, run, x):
    """``run(tp, p, x)`` → a scalar, on this rank's pieces of ``whole``
    (one layer's params) and on the whole params alone; returns the
    largest relative gap of any leaf's gradient and of x's, and whether
    the forward values agree (within FORM_RTOL)."""
    from repro_torch.dist.tensor_parallel import TensorParallel
    from repro_torch.training.tree import leaves, unflatten
    flat, tree, sh = _pieces(mesh, model, whole)
    xs = x.detach().clone().requires_grad_(True)
    val = run(TensorParallel(mesh), tree, xs)
    gs = torch.autograd.grad(val, flat + [xs], allow_unused=True)
    ones = [w.detach().clone().requires_grad_(True) for w in leaves(whole)]
    x1 = x.detach().clone().requires_grad_(True)
    val1 = run(TensorParallel(None), unflatten(whole, ones), x1)
    g1 = torch.autograd.grad(val1, ones + [x1], allow_unused=True)
    # the layer's leaves (the others reach no gradient on either side)
    errs = [_rel(_gather_whole(mesh, g, s), w)
            for g, s, w in zip(gs[:-1], sh, g1[:-1]) if w is not None]
    return dict(leaves=max(errs), x=_rel(gs[-1], g1[-1]),
                value=abs(float(val) - float(val1)) / abs(float(val1)))


def _rglru_fault(mesh):
    """``TensorParallel.rglru`` on the smoke recurrentgemma's first RG-LRU
    layer (``d_rnn`` split over ``model``): gradients against one
    device's."""
    from repro_torch.models import build_model
    cfg = _cfg("recurrentgemma-9b")
    model = build_model(cfg)
    whole = model.init(torch.Generator().manual_seed(4), "cpu")
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(2, 12, cfg.d_model, generator=gen)
    w = torch.randn(2, 12, cfg.d_model, generator=gen)

    def run(tp, p, xs):
        y, _ = tp.rglru(p["layers"][0]["rec"], xs)
        return (y * w).sum()
    return _form_grads(mesh, model, whole, run, x)


def _moe_fault(mesh):
    """``TensorParallel.moe`` on the smoke qwen3-moe's first layer (8
    experts, 4 a rank), its output and its load-balancing term (weighted
    1, so its gradient counts): the router's, the experts' and x's
    gradients against one device's."""
    from repro_torch.models import build_model
    cfg = _cfg("qwen3-moe-235b-a22b")
    model = build_model(cfg)
    whole = model.init(torch.Generator().manual_seed(6), "cpu")
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(2, 16, cfg.d_model, generator=gen)
    w = torch.randn(2, 16, cfg.d_model, generator=gen)
    kw = dict(num_experts=cfg.num_experts, top_k=cfg.experts_per_token,
              capacity_factor=cfg.capacity_factor, activation=cfg.activation,
              group_size=cfg.moe_group)

    def run(tp, p, xs):
        y, aux = tp.moe(p["layers"][0]["moe"], xs, **kw)
        return (y.float() * w).sum() + aux
    return _form_grads(mesh, model, whole, run, x)


class _Widths(torch.utils._python_dispatch.TorchDispatchMode):
    """The largest last dim of any tensor an op makes."""

    def __init__(self):
        super().__init__()
        self.widest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.ndim:
                self.widest = max(self.widest, t.shape[-1])
        return out


def _vocab_ce(mesh):
    """``TensorParallel.cross_entropy`` of a (d, 512) head split over
    ``model``, 300 real columns (the pad columns on the last rank), labels
    on every rank's columns, against ``core.metrics.cross_entropy`` of the
    whole logits: with a mask whose first two rows are all zero, without
    a mask, and with an all-zero mask. (loss gap, head and x gradient
    gaps, the widest tensor made) a case."""
    from repro_torch.core.metrics import cross_entropy
    from repro_torch.dist.collective_ops import shard_local, to_dtensor
    from repro_torch.dist.tensor_parallel import TensorParallel
    from repro_torch.models.layers import logits_apply
    from repro_torch.sharding import named_sharding
    gen = torch.Generator().manual_seed(8)
    d, rows, cols = 32, 4, 9
    w = torch.randn(d, CE_PADDED, generator=gen) / d ** 0.5
    x = torch.randn(rows, cols, d, generator=gen)
    labels = torch.randint(0, CE_VOCAB, (rows, cols), generator=gen)
    labels[:, -3:] = torch.tensor([3, CE_PADDED // 2 + 1, CE_VOCAB - 1])
    sh = named_sharding(mesh, ("embed", "vocab"), w.shape)
    tp = TensorParallel(mesh)
    mask = torch.ones(rows, cols - 1)
    mask[:2] = 0
    mask[2, 4:] = 0
    out = {"split": tp.split_dim(to_dtensor(
        shard_local(w, mesh, sh.placements), mesh, sh.placements, w.shape))}
    for name, m in (("mask", mask), ("none", None),
                    ("zero", torch.zeros(rows, cols - 1))):
        wl = shard_local(w, mesh, sh.placements).requires_grad_(True)
        xs = x.clone().requires_grad_(True)
        with _Widths() as widths:
            loss = tp.cross_entropy(
                {"w": to_dtensor(wl, mesh, sh.placements, w.shape)}, xs,
                labels, m, CE_VOCAB)
            gw, gx = torch.autograd.grad(loss, [wl, xs])
        w1 = w.clone().requires_grad_(True)
        x1 = x.clone().requires_grad_(True)
        want = cross_entropy(logits_apply({"w": w1}, x1, CE_VOCAB)[:, :-1],
                             labels[:, 1:], m)
        gw1, gx1 = torch.autograd.grad(want, [w1, x1])
        gw = _gather_whole(mesh, gw, sh)
        out[name] = dict(
            loss=(float(loss), float(want)),
            w=float((gw - gw1).abs().max()) / max(float(gw1.abs().max()),
                                                  1e-30),
            x=float((gx - gx1).abs().max()) / max(float(gx1.abs().max()),
                                                  1e-30),
            widest=widths.widest, zero_grads=bool(
                torch.all(gw == 0) and torch.all(gx == 0)))
    return out


def _zoo_train_rank(mesh, trees, batches):
    """Every family's sharded loss and gradients (whole, numpy) on this
    rank, with its routing, then the forms' gradient checks."""
    from repro_torch.models import build_model
    from repro_torch.training import OptConfig, jit_train_step
    arch_ns = types.SimpleNamespace(grad_accum=1, zero1=True)
    out = {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        model = build_model(cfg)
        params = _port_params(cfg, trees[arch])
        batch = _torch(batches[arch])
        step = jit_train_step(mesh, model, arch_ns, OptConfig(), batch)
        with _Routes() as routes:
            loss, grads = step.grads(params, batch)
        out[arch] = dict(loss=float(loss), grads=_whole(grads),
                         routes=routes)
    out["rglru"] = _rglru_fault(mesh)
    out["moe"] = _moe_fault(mesh)
    out["ce"] = _vocab_ce(mesh)
    return out


# ---------------------------------------------------------------- fixture

def _temper(tree):
    out = dict(tree)
    for blk in ("enc_blocks", "dec_blocks"):
        b = dict(out[blk])
        for att in ("attn", "xattn"):
            if att in b:
                b[att] = dict(b[att], wq=b[att]["wq"] * TEMPER,
                              wk=b[att]["wk"] * TEMPER)
        out[blk] = b
    return out


@pytest.fixture(scope="module")
def runs():
    """The reference's one-device loss and gradients, the port's
    one-device step and routing, both meshes' rank results and the two
    CLI runs (all at once)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import smoke_config as jsmoke
    from repro.models import build_model as jbuild
    from repro_torch.models import build_model
    from repro_torch.training.train_loop import value_and_grad
    from repro_torch.training.tree import leaves
    trees, batches, jnets, jparams = {}, {}, {}, {}
    for arch in ARCHS:
        jnets[arch] = jbuild(jsmoke(arch))
        jp = jnets[arch].init(jax.random.key(0))
        jparams[arch] = _temper(jp) if arch == ENCDEC else jp
        trees[arch] = jax.tree.map(np.asarray, jparams[arch])
        batches[arch] = _batch(_cfg(arch))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    clis = {a: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", a,
         "--mesh", "1,2"] + TRAIN_ARGS, cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for a in CLI_ARCHS}
    with concurrent.futures.ThreadPoolExecutor(len(MESHES)) as pool:
        futs = {m: pool.submit(run_ranks, _zoo_train_rank, *m,
                               args=(trees, batches)) for m in MESHES}
        want = {}
        for arch in ARCHS:
            jb = {k: jnp.asarray(v) for k, v in batches[arch].items()}
            jl, jg = jax.jit(jax.value_and_grad(jnets[arch].loss))(
                jparams[arch], jb)
            cfg = _cfg(arch)
            model = build_model(cfg)
            params = _port_params(cfg, trees[arch])
            with _Routes() as routes:
                l1, g1 = value_and_grad(model.loss, params,
                                        _torch(batches[arch]))
            jgt = _port_params(cfg, jax.tree.map(np.asarray, jg))
            want[arch] = dict(
                ref_loss=float(jl), ref=[x.float().numpy()
                                         for x in leaves(jgt)],
                loss=float(l1), grads=[x.numpy() for x in leaves(g1)],
                routes=routes)
        ranks = {m: f.result() for m, f in futs.items()}
    from repro_torch.launch import train
    one = {a: train.main(["--arch", a] + TRAIN_ARGS) for a in CLI_ARCHS}
    cli = {a: (p.wait(timeout=600), p.stdout.read()) for a, p in clis.items()}
    return dict(want=want, ranks=ranks, cli=cli, one=one)


# ------------------------------------------------------------------ tests

def _gap(a, b) -> float:
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-6)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_loss_and_grads_match_reference(runs, mesh, arch):
    """The sharded step's loss (the whole batch's masked mean plus, for
    a MoE, the whole batch's load-balancing term) and every gradient leaf
    against the reference's one-device ``value_and_grad``."""
    want = runs["want"][arch]
    for rk in runs["ranks"][mesh]:
        got = rk[arch]
        np.testing.assert_allclose(got["loss"], want["ref_loss"],
                                   rtol=LOSS_RTOL)
        for a, b in zip(got["grads"], want["ref"]):
            assert a.shape == b.shape
            assert _gap(a, b) <= REF_GRAD[arch]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_grads_match_one_device(runs, mesh, arch):
    """Against the port's one-device step: the loss within
    SELF_LOSS_RTOL, every gradient leaf within the family's own rounding
    spread (``SELF_GRAD``)."""
    want = runs["want"][arch]
    for rk in runs["ranks"][mesh]:
        got = rk[arch]
        np.testing.assert_allclose(got["loss"], want["loss"],
                                   rtol=SELF_LOSS_RTOL)
        worst = max(_gap(a, b) for a, b in zip(got["grads"], want["grads"]))
        assert worst <= SELF_GRAD[arch], worst


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_ranks_agree_bitwise(runs, mesh):
    """Every rank of a mesh holds the same loss and the same whole
    gradients, bit for bit."""
    first, *rest = runs["ranks"][mesh]
    for rk in rest:
        for arch in ARCHS:
            assert rk[arch]["loss"] == first[arch]["loss"]
            for a, b in zip(rk[arch]["grads"], first[arch]["grads"]):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_moe_routing_exact(runs, mesh, arch):
    """Each rank routes its data group's rows as one device routes them:
    expert ids, ranks within the experts and the drop set exact, in the
    forward and in every layer's recomputation."""
    want = runs["want"][arch]["routes"]
    d = mesh[0]
    for r, rk in enumerate(runs["ranks"][mesh]):
        got = rk[arch]["routes"]
        assert len(got) == len(want) > 0
        g = r // mesh[1]                 # the rank's data group
        for (ids, rank, C), (wids, wrank, wC) in zip(got, want):
            n = wids.shape[0] // d
            assert C == wC
            np.testing.assert_array_equal(ids, wids[g * n:(g + 1) * n])
            np.testing.assert_array_equal(rank, wrank[g * n:(g + 1) * n])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_rglru_gate_gradients(runs, mesh):
    """The RG-LRU gates on a rank's ``d_rnn`` rows: every rank's column
    gradients reach its rows (``reduce_slices``' all-gather backward), so
    ``w_gate_a`` / ``w_gate_x`` and every other leaf, and x, get one
    device's gradients."""
    for rk in runs["ranks"][mesh]:
        got = rk["rglru"]
        assert got["value"] <= FORM_RTOL
        assert got["leaves"] <= FORM_RTOL, got
        assert got["x"] <= FORM_RTOL, got


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_moe_router_and_aux_gradients(runs, mesh):
    """Expert parallelism's router and load-balancing term: the router's
    gradient sums every rank's combine terms and counts the term once, and
    so does x's."""
    for rk in runs["ranks"][mesh]:
        got = rk["moe"]
        assert got["value"] <= FORM_RTOL
        assert got["leaves"] <= FORM_RTOL, got
        assert got["x"] <= FORM_RTOL, got


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_vocab_parallel_cross_entropy(runs, mesh):
    """The loss within CE_LOSS_RTOL of the gathered logits' and the
    head's and x's gradients within CE_GRAD of their largest entries, with
    the pad columns on the last rank, labels on every rank's columns, a
    mask with an all-zero row group and without one; an all-zero mask
    gives 0 and zero gradients; no tensor as wide as the padded
    vocabulary is made."""
    for rk in runs["ranks"][mesh]:
        ce = rk["ce"]
        assert ce["split"] == 1
        for case in ("mask", "none", "zero"):
            got = ce[case]
            a, b = got["loss"]
            assert abs(a - b) <= CE_LOSS_RTOL * abs(b), (case, a, b)
            assert got["w"] <= CE_GRAD and got["x"] <= CE_GRAD, (case, got)
            assert got["widest"] < CE_PADDED
        assert ce["zero"]["loss"] == (0.0, 0.0) and ce["zero"]["zero_grads"]


@pytest.mark.parametrize("arch", CLI_ARCHS)
def test_launch_train_mesh_cli(runs, arch):
    """``launch.train --arch ARCH --smoke --mesh 1,2 --device cpu`` runs
    end to end on two spawned ranks; its first loss is one device's (to
    the four decimals it prints)."""
    rc, text = runs["cli"][arch]
    assert rc == 0, text[-3000:]
    assert "mesh: {'data': 1, 'model': 2}" in text
    m = re.search(r"step\s+0 loss (\S+)", text)
    assert m is not None, text[-2000:]
    assert abs(float(m.group(1)) - runs["one"][arch]["losses"][0]) <= 6e-5


def _masked_after_exp(rb, kb, lwb):
    """The reference's intra-chunk decays: exp of every pair, then the
    strict lower triangle kept."""
    logc = torch.cumsum(lwb, dim=2)
    L = rb.shape[2]
    idx = torch.arange(L)
    tri = idx[:, None] > idx[None, :]
    decay3 = torch.where(tri[None, None, :, :, None], torch.exp(
        (logc - lwb)[:, :, :, None, :] - logc[:, :, None, :, :]), 0.0)
    return (decay3 * rb[:, :, :, None, :] * kb[:, :, None, :, :]).sum(-1)


def test_rwkv_decay_gradients_finite_past_exp_range():
    """An RWKV6 chunk whose log decays (full width's reach -exp(4) a
    step) sum past exp's range: ``_chunk_step``'s output is the same
    bitwise with the upper triangle masked before exp as after it (the
    reference's order), and its gradients are finite where that order's
    are NaN."""
    import math
    from repro_torch.models.recurrent import _chunk_step
    g = torch.Generator().manual_seed(0)
    B, H, L, Dk = 1, 2, 8, 4
    r, k, v, S0 = (torch.randn(*s, generator=g) for s in
                   ((B, H, L, Dk),) * 3 + ((B, H, Dk, Dk),))
    u = torch.randn(H, Dk, generator=g)
    lw = (-torch.rand(B, H, L, Dk, generator=g) * math.exp(4.0))
    ins = [t.clone().requires_grad_() for t in (r, k, v, lw)]
    S, o = _chunk_step(S0, *ins[:3], ins[3], u)
    (S.sum() + o.sum()).backward()
    assert all(bool(t.grad.isfinite().all()) for t in ins)
    att = torch.einsum("bhts,bhse->bhte", _masked_after_exp(r, k, lw), v)
    bonus = torch.einsum("bhld,bhld->bhl", r, u[None, :, None, :] * k)
    logc_excl = torch.cumsum(lw, dim=2) - lw
    want = (torch.einsum("bhld,bhde->bhle", r * torch.exp(logc_excl), S0)
            + att + bonus[..., None] * v)
    assert torch.equal(o.detach(), want)
    old = [t.clone().requires_grad_() for t in (r, k, lw)]
    _masked_after_exp(*old).sum().backward()
    assert not bool(old[2].grad.isfinite().all())

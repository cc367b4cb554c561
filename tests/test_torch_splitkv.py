"""Split-KV sharded decode of the dense GQA transformers
(``repro_torch.dist.splitkv``, ``TransformerLM.with_mesh``,
``ServeEngine(mesh=)``, ``launch.serve --mesh``) and B14's log-sum-exp
output, on gloo CPU ranks at meshes (1, 2), (1, 4) and (2, 2).

On ``smoke_config('qwen3-0.6b')`` and ``smoke_config('llama3.2-3b')``: a
sharded prefill and eight decode steps (an int position, then per-row
positions), each rank on its data group's rows, logits within the port's
per-model tolerance of the JAX reference's unsharded ``decode_step``
(``tests/test_torch_transformer.py``: llama 5e-4, qwen3 1e-5), as the
reference's own sharded decode is held in ``tests/test_distributed.py``,
and within ``SELF_ATOL`` of the port's own unsharded step; greedy ``generate``
tokens equal to one device's; the first decode steps leave segments with
no live key; the training forward's loss and gradients through the same
tensor-parallel forms (q / k / v heads split, or k / v whole at (1, 4),
with the qk-norm weights' gradients summed over the ranks) against the
port's one-device ones. The plain B14's ``lse=`` and the split-KV
``merge`` on one
process; ``launch.serve --arch qwen3-0.6b --mesh 1,2 --device cpu
--smoke`` end to end, and what ``--mesh`` refuses (the rest of the
attention zoo: ``tests/test_torch_splitkv_zoo.py``).

Each mesh's ranks start once, all at the same time; the rank functions
live here and import no JAX.
"""
import concurrent.futures
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.launch.mesh import run_ranks

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen3-0.6b", "llama3.2-3b")
# tests/test_torch_transformer.py's ATOL: the port's logits against the
# reference's (llama's smoke scores reach ~100: a last-bit difference
# moves the reference's own logits by ~7e-5)
REF_ATOL = {"qwen3-0.6b": 1e-5, "llama3.2-3b": 5e-4}
# sharded against the port's one-device step: qwen3 (qk-normed) within
# 1e-5; llama within its own one-ulp spread (a last-bit change of half
# the reference's embedding moves its logits by 6.9e-5,
# test_torch_transformer.py::test_last_bit_sensitivity; measured 1.8e-5
# at (1, 4), where the partial sums of wo and the MLP split four ways)
SELF_ATOL = {"qwen3-0.6b": 1e-5, "llama3.2-3b": 7e-5}
# the tensor-parallel training gradients against one device's, of each
# leaf's max: qwen3 to 1e-6 (measured 7.8e-7 at (1, 4)); llama to its
# rounding spread (tests/test_torch_sharded_train.py's TP_GRAD_ATOL;
# measured 3.0e-5)
TP_GRAD_ATOL = {"qwen3-0.6b": 1e-6, "llama3.2-3b": 5e-5}
MESHES = [(1, 2), (1, 4), (2, 2)]
B, S, STEPS, MAX_LEN, GEN = 4, 7, 8, 40, 6
LSE_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(cfg):
    rng = np.random.default_rng(1)
    return (rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            rng.integers(0, cfg.vocab_size, (B, STEPS)).astype(np.int32))


def _positions(t):
    """Step t's positions: an int for the first half, then per-row ones
    (rows at different depths)."""
    if t < STEPS // 2:
        return S + t
    return np.asarray([S + t, S + t - 3, S + t - 1, S + t - 2], np.int32)


# ------------------------------------------------------------ rank bodies

def _decode_rank(mesh, trees):
    """Every arch: the rank's rows prefilled and decoded STEPS steps
    through the split-KV model, the local lengths of its segment at the
    first step, and a greedy ``generate`` through ``ServeEngine``."""
    from repro_torch.configs import smoke_config
    from repro_torch.dist.collective_ops import batch_rows
    from repro_torch.dist.splitkv import (cache_segment,
                                          partition_transformer_params)
    from repro_torch.models import build_model, transformer_params_from_numpy
    from repro_torch.serving import ServeEngine, cache_shardings
    out = {}
    rows = batch_rows(mesh, B)
    for arch in ARCHS:
        cfg = smoke_config(arch)
        model = build_model(cfg)
        whole = transformer_params_from_numpy(cfg, trees[arch], "cpu")
        meshed = model.with_mesh(mesh)
        params = partition_transformer_params(whole, meshed, mesh)
        prompt, toks = (torch.as_tensor(x[rows]) for x in _inputs(cfg))
        logits, cache = meshed.prefill(params, prompt, MAX_LEN)
        steps = [logits.numpy()]
        s0, s1 = cache_segment(mesh, MAX_LEN)
        empty = int(S + 1 - s0 <= 0)
        for t in range(STEPS):
            pos = _positions(t)
            pos = pos if isinstance(pos, int) else torch.as_tensor(pos[rows])
            logits, cache = meshed.decode_step(params, cache,
                                               toks[:, t:t + 1], pos)
            steps.append(logits.numpy())
        eng = ServeEngine(model, max_len=MAX_LEN, device="cpu", mesh=mesh)
        p, _ = eng.prepare(whole)
        gen = eng.generate(p, torch.as_tensor(_inputs(cfg)[0]), GEN)
        sh = cache_shardings(mesh, eng.model, B, MAX_LEN)["layers"][0]
        train = _tp_grads(mesh, model, whole)
        out[arch] = dict(steps=steps, rows=(rows.start, rows.stop),
                         train=train,
                         segment=(s0, s1), empty_first=empty,
                         cache_rows=tuple(cache["layers"][0]["k"].shape),
                         tokens=gen.numpy(), dist=eng._dist,
                         cache_sh={k: tuple(v) for k, v in sh.items()})
    return out


def _tp_grads(mesh, model, whole):
    """(relative loss gap, each leaf's max gradient gap over its max) of
    the sharded train step's gradients against ``value_and_grad`` of the
    whole batch on one device."""
    import types
    from repro_torch.dist.collective_ops import full_tensor
    from repro_torch.training import OptConfig, jit_train_step
    from repro_torch.training.train_loop import value_and_grad
    from repro_torch.training.tree import leaves
    raw = torch.as_tensor(np.random.default_rng(1).integers(
        0, model.cfg.vocab_size, (B, 8)))
    batch = {"tokens": raw, "labels": raw}
    step = jit_train_step(mesh, model, types.SimpleNamespace(grad_accum=1),
                          OptConfig(), batch)
    loss, grads = step.grads(whole, batch)
    l1, g1 = value_and_grad(model.loss, whole, batch)
    return (abs(float(loss) - float(l1)) / float(l1),
            max(float((full_tensor(a) - b).abs().max() / b.abs().max())
                for a, b in zip(leaves(grads), leaves(g1))))


# ---------------------------------------------------------------- fixture

@pytest.fixture(scope="module")
def runs():
    """The reference's unsharded prefill and decode, the port's
    one-device ones and greedy tokens, and every mesh's rank results (the
    three meshes and the serve CLI at once)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import smoke_config as jsmoke
    from repro.models import build_model as jbuild
    from repro_torch.configs import smoke_config
    from repro_torch.models import build_model, transformer_params_from_numpy
    from repro_torch.serving import ServeEngine
    jnets = {a: jbuild(jsmoke(a)) for a in ARCHS}
    jparams = {a: m.init(jax.random.key(0)) for a, m in jnets.items()}
    trees = {a: jax.tree.map(np.asarray, p) for a, p in jparams.items()}
    cli = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3-0.6b", "--mesh", "1,2", "--device", "cpu", "--smoke"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    with concurrent.futures.ThreadPoolExecutor(len(MESHES)) as pool:
        futs = {m: pool.submit(run_ranks, _decode_rank, *m, args=(trees,))
                for m in MESHES}
        want = {}
        for arch in ARCHS:
            cfg = smoke_config(arch)
            prompt, toks = _inputs(cfg)
            jl, jc = jnets[arch].prefill(jparams[arch], jnp.asarray(prompt),
                                         MAX_LEN)
            model = build_model(cfg)
            params = transformer_params_from_numpy(cfg, trees[arch], "cpu")
            tl, tc = model.prefill(params, torch.as_tensor(prompt), MAX_LEN)
            js, ts = [np.asarray(jl, np.float32)], [tl.numpy()]
            for t in range(STEPS):
                pos = _positions(t)
                jl, jc = jnets[arch].decode_step(
                    jparams[arch], jc, jnp.asarray(toks[:, t:t + 1]),
                    pos if isinstance(pos, int) else jnp.asarray(pos))
                tl, tc = model.decode_step(
                    params, tc, torch.as_tensor(toks[:, t:t + 1]),
                    pos if isinstance(pos, int) else torch.as_tensor(pos))
                js.append(np.asarray(jl, np.float32))
                ts.append(tl.numpy())
            eng = ServeEngine(model, max_len=MAX_LEN, device="cpu")
            gen = eng.generate(params, torch.as_tensor(prompt), GEN)
            want[arch] = dict(ref=js, port=ts, tokens=gen.numpy())
        out = {m: f.result() for m, f in futs.items()}
    text, _ = cli.communicate(timeout=600)
    return dict(want=want, ranks=out, cli=(cli.returncode, text))


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_splitkv_decode_matches_reference(runs, mesh, arch):
    """Prefill and every decode step's logits on every rank's rows:
    within the port's per-model tolerance of the reference's unsharded
    ``decode_step``, and within ``SELF_ATOL`` of the port's own."""
    want = runs["want"][arch]
    for rk in runs["ranks"][mesh]:
        got = rk[arch]
        lo, hi = got["rows"]
        assert got["cache_rows"][1] == MAX_LEN // mesh[1]
        for t, g in enumerate(got["steps"]):
            np.testing.assert_allclose(g, want["ref"][t][lo:hi], rtol=0,
                                       atol=REF_ATOL[arch], err_msg=str(t))
            np.testing.assert_allclose(g, want["port"][t][lo:hi], rtol=0,
                                       atol=SELF_ATOL[arch], err_msg=str(t))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_tensor_parallel_training_grads(runs, mesh, arch):
    """The training forward through the decode's tensor-parallel forms:
    the loss within 1e-6 and every gradient leaf within
    ``TP_GRAD_ATOL`` of its max of one device's."""
    for rk in runs["ranks"][mesh]:
        dl, dg = rk[arch]["train"]
        assert dl <= 1e-6 and dg <= TP_GRAD_ATOL[arch], (dl, dg)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_splitkv_generate_tokens_equal_one_device(runs, mesh):
    """Greedy ``ServeEngine.generate`` under the mesh: the whole batch's
    tokens, on every rank, equal to one device's; the engine partitioned
    the params."""
    for arch in ARCHS:
        for rk in runs["ranks"][mesh]:
            assert rk[arch]["dist"]
            assert np.array_equal(rk[arch]["tokens"],
                                  runs["want"][arch]["tokens"])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_cache_shardings_split_kv(runs, mesh):
    """``cache_shardings`` of the split-KV model: k and v split over
    ``data`` on the batch (B=4 divides; a one-rank axis too, as the rule
    table resolves it) and over ``model`` on ``cache_seq``, the rank's
    cache its segment of MAX_LEN / model rows."""
    from torch.distributed.tensor import Shard
    want = (Shard(0), Shard(1))
    for rk in runs["ranks"][mesh]:
        for arch in ARCHS:
            sh = rk[arch]["cache_sh"]
            assert sh["k"] == sh["v"] == want
            assert rk[arch]["segment"][1] - rk[arch]["segment"][0] == \
                MAX_LEN // mesh[1]


@pytest.mark.parametrize("mesh", [(1, 2), (1, 4)], ids=["1x2", "1x4"])
def test_empty_segments_in_the_run(runs, mesh):
    """The first decode step reads S + 1 = 8 positions: with segments of
    MAX_LEN / model positions, the ranks past the first hold no live key
    then, and their logits still match (the combine gives them weight
    0)."""
    ranks = runs["ranks"][mesh]
    empty = [rk["qwen3-0.6b"]["empty_first"] for rk in ranks]
    assert empty[0] == 0 and all(empty[1:])


def test_lse_plain_version():
    """The plain B14 with ``lse=``: the output unchanged, each row's
    log-sum-exp that of its scaled scores (float64 logsumexp), -inf and 0
    for a row with no live key; a window too."""
    g = torch.Generator().manual_seed(0)
    Bq, Hq, Hkv, Sk, D = 5, 8, 2, 50, 32
    q = torch.randn(Bq, Hq, D, generator=g)
    k = torch.randn(Bq, Hkv, Sk, D, generator=g)
    v = torch.randn(Bq, Hkv, Sk, D, generator=g)
    lengths = torch.tensor([0, 1, 17, 50, 33], dtype=torch.int32)
    for window in (None, 8):
        lse = torch.empty(Bq, Hq)
        o = ops.decode_attention(q, k, v, lengths, window=window, lse=lse,
                                 backend="ref")
        assert torch.equal(o, ops.decode_attention(q, k, v, lengths,
                                                   window=window,
                                                   backend="ref"))
        kf = k.double().repeat_interleave(Hq // Hkv, 1)
        s = torch.einsum("bhd,bhkd->bhk", q.double(), kf) * D ** -0.5
        kpos = torch.arange(Sk)
        n = lengths[:, None, None].long()
        live = kpos < n
        if window is not None:
            live = live & (kpos > n - 1 - window)
        want = torch.logsumexp(s.masked_fill(~live, float("-inf")), -1)
        assert torch.isinf(lse[0]).all() and (lse[0] < 0).all()
        assert not o[0].any()
        np.testing.assert_allclose(lse[1:].numpy(), want[1:].numpy(),
                                   rtol=0, atol=LSE_ATOL)


def test_lse_argument_checks():
    q, k = torch.zeros(2, 4, 32), torch.zeros(2, 2, 8, 32)
    n = torch.ones(2, dtype=torch.int32)
    for bad in (torch.zeros(2, 4, dtype=torch.float64), torch.zeros(2, 3),
                torch.zeros(4, 2).t()):
        with pytest.raises(ValueError, match="lse"):
            ops.decode_attention(q, k, k, n, lse=bad, backend="ref")


def test_merge_of_segments_is_the_whole():
    """Keys split into segments (one empty, one ragged): each segment's
    plain B14 with ``lse``, merged, equals the whole cache's attention;
    segments all empty give 0, never NaN."""
    from repro_torch.dist.splitkv import merge
    g = torch.Generator().manual_seed(1)
    Bq, Hq, Hkv, D = 3, 4, 2, 16
    bounds = [(0, 12), (12, 20), (20, 36), (36, 40)]
    q = torch.randn(Bq, Hq, D, generator=g)
    k = torch.randn(Bq, Hkv, 40, D, generator=g)
    v = torch.randn(Bq, Hkv, 40, D, generator=g)
    lengths = torch.tensor([5, 29, 40], dtype=torch.int32)
    whole = ref.decode_attention_window_ref(q, k, v, lengths)
    os_, ls = [], []
    for s0, s1 in bounds:
        lse = torch.empty(Bq, Hq)
        local = (lengths - s0).clamp(0, s1 - s0).to(torch.int32)
        os_.append(ref.decode_attention_window_ref(
            q, k[:, :, s0:s1], v[:, :, s0:s1], local, lse=lse))
        ls.append(lse)
    got = merge(torch.stack(os_), torch.stack(ls))
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=0,
                               atol=1e-6)
    none = merge(torch.zeros(3, Bq, Hq, D),
                 torch.full((3, Bq, Hq), float("-inf")))
    assert not none.isnan().any() and not none.any()


def test_serve_cli_mesh_transformer(runs):
    """``launch.serve --arch qwen3-0.6b --mesh 1,2 --device cpu --smoke``
    runs end to end on two spawned ranks."""
    rc, text = runs["cli"]
    assert rc == 0, text[-3000:]
    assert "mesh: data=1 model=2 over 2 ranks, gloo" in text
    assert "generated (4, 32)" in text


@pytest.mark.parametrize("argv,match", [
    (["--arch", "granite-moe-1b-a400m", "--traffic"], None),
    (["--arch", "recurrentgemma-9b"], None),
    (["--arch", "seamless-m4t-medium", "--continuous"], None),
    (["--arch", "llava-next-34b", "--prompt-len", "21", "--gen", "4"],
     "must split"),
    (["--arch", "qwen3-0.6b", "--continuous"], None),
    (["--arch", "qwen3-0.6b", "--prompt-len", "15", "--gen", "4"],
     "must split"),
], ids=["moe", "recurrent", "encdec", "vlm", "continuous", "segments"])
def test_serve_mesh_refusals(argv, match, capsys):
    """``--mesh`` refuses, before any rank starts, a cache whose positions
    do not split over the model axis; it takes the recurrent families and
    every family under the scheduler (``--continuous`` / ``--traffic``):
    its checks give the mesh's (data, model) and name no refusal (the
    runs themselves: tests/test_torch_splitkv_recurrent.py,
    tests/test_torch_sched_mesh.py)."""
    from repro_torch.launch import serve
    argv = argv + ["--mesh", "1,2", "--smoke", "--device", "cpu"]
    if match is None:
        ap = serve.parser()
        assert serve._mesh_shape(ap, ap.parse_args(argv)) == (1, 2)
        assert not capsys.readouterr().err
        return
    with pytest.raises(SystemExit):
        serve.main(argv)
    assert match in capsys.readouterr().err


class _Mesh:
    """A (data, model) = (1, 2) mesh's layout, as rank ``rank`` reads it."""

    def __init__(self, rank):
        self.mesh_dim_names, self.shape, self.rank = ("data", "model"), \
            (1, 2), rank

    def get_local_rank(self, axis):
        return self.rank if axis == "model" else 0


def test_with_mesh_refuses_other_families():
    """Every family takes a mesh: the recurrent ones too, each rank's
    cache its pieces (recurrentgemma's attention segment and ``d_rnn``
    slice of ``h`` / ``conv``, rwkv6's heads of ``S``, ``x_tm`` / ``x_cm``
    whole); None gives the one-device model back."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import build_model
    for arch in ("recurrentgemma-9b", "rwkv6-7b"):
        cfg = smoke_config(arch)
        model = build_model(cfg)
        for rank in (0, 1):
            net = model.with_mesh(_Mesh(rank))
            assert net.mesh is not None and net.tp.rank == rank
            layers = net.cache_defs(4, 48)["layers"]
            whole = model.cache_defs(4, 48)["layers"]
            for kind, got, want in zip(model.kinds, layers, whole):
                for name, d in got.items():
                    shape = list(want[name].shape)
                    if kind.startswith("attn"):
                        shape[1] //= 2
                    elif name in ("h", "conv", "S"):
                        shape[-1 if name != "S" else 1] //= 2
                    assert tuple(d.shape) == tuple(shape), (arch, name)
    model = build_model(smoke_config("qwen3-0.6b"))
    assert model.with_mesh(None).mesh is None and model.mesh is None

"""Sharded serving of the recurrent families (``dist.tensor_parallel``'s
``rglru`` / ``rwkv_time_mix`` / ``rwkv_channel_mix`` forms, the windowed
split-KV of ``dist.splitkv``, ``TransformerLM.with_mesh``) on gloo CPU
ranks at meshes (1, 2) and (2, 2).

On ``smoke_config('recurrentgemma-9b')`` (window 32, one kv head) and
``smoke_config('rwkv6-7b')``: a sharded prefill of 40 tokens and six
decode steps (an int position, then per-row positions) into a cache of
48 positions, so that at (1, 2) every decode step's window edge (lengths
41-46, first keys 9-14) lies inside rank 0's full segment of 24; logits
within the reference's recurrent tolerances of the JAX package's
unsharded ``decode_step`` (ROADMAP "Recurrent families' tolerances":
recurrentgemma 1e-3, rwkv6 1e-4) and within ``SELF_ATOL`` of the port's
own one-device step. The windowed prefill on a rank's heads equals the
one-device windowed prefill's heads. The plain B14 with ``start=``,
merged over segments (one wholly before the window), equals the whole
windowed cache. Each rank's cache and param pieces equal the shard
shapes the reference's ``resolve_spec`` gives, on these meshes and on
both production meshes. ``launch.serve --mesh 1,2 --smoke`` serves both
archs end to end.

Each mesh's ranks start once, both at the same time; the rank functions
live here and import no JAX.
"""
import concurrent.futures
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.launch.mesh import run_ranks

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("recurrentgemma-9b", "rwkv6-7b")
# the reference's recurrent tolerances (tests/test_torch_recurrent.py)
REF_ATOL = {"recurrentgemma-9b": 1e-3, "rwkv6-7b": 1e-4}
# sharded against the port's one-device step: the partial sums of
# w_out, the gates and the MLP reduce in another order, and the smoke
# hybrid amplifies a last-bit change (one ulp on half the reference's
# embedding moves its logits by 2.3e-4, ROADMAP): measured 6.5e-4 (the
# first decode step, rows 0-1; the sharded run is then 7.1e-4 from the
# reference); rwkv6 measured 2.9e-6
SELF_ATOL = {"recurrentgemma-9b": 1e-3, "rwkv6-7b": 1e-5}
MESHES = [(1, 2), (2, 2)]
B, S, STEPS, MAX_LEN = 4, 40, 6, 48
WINDOW = 32                   # smoke recurrentgemma's
HEAD_ATOL = 1e-6              # a rank's windowed prefill heads vs one device's


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch):
    from repro_torch.configs import smoke_config
    return smoke_config(arch)


def _inputs(cfg):
    rng = np.random.default_rng(1)
    return (rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            rng.integers(0, cfg.vocab_size, (B, STEPS)).astype(np.int32))


def _positions(t):
    if t < STEPS // 2:
        return S + t
    return np.asarray([S + t, S + t - 3, S + t - 1, S + t - 2], np.int32)


def _run(model, params, prompt, toks, rows=slice(None)):
    """Prefill and STEPS decode steps of ``rows``: each one's logits."""
    logits, cache = model.prefill(params, torch.as_tensor(prompt[rows]),
                                  MAX_LEN)
    out = [logits.numpy()]
    for t in range(STEPS):
        pos = _positions(t)
        pos = pos if isinstance(pos, int) else torch.as_tensor(pos[rows])
        logits, cache = model.decode_step(params, cache,
                                          torch.as_tensor(toks[rows, t:t + 1]),
                                          pos)
        out.append(logits.numpy())
    return out


class FakeMesh:
    """The parts of a DeviceMesh that the model's layout reads: axis names
    and sizes, rank 0's coordinates."""

    def __init__(self, names, shape):
        self.mesh_dim_names, self.shape = tuple(names), tuple(shape)

    def get_local_rank(self, axis):
        return 0

    def size(self, i=None):
        return int(np.prod(self.shape)) if i is None else self.shape[i]


PROD_MESHES = {"pod16x16": FakeMesh(("data", "model"), (16, 16)),
               "pod2x16x16": FakeMesh(("pod", "data", "model"), (2, 16, 16))}


def _pieces(mesh, B_rows, max_len):
    """Each arch's cache pieces (per layer kind, the rank's leaf shapes)
    and param pieces (per block kind and the top-level leaves) on
    ``mesh``, from the meshed model and the rule table."""
    from repro_torch.models import build_model
    from repro_torch.models.layers import PSpec
    from repro_torch.training.train_loop import param_shardings
    from repro_torch.training.tree import leaves
    out = {}
    for arch in ARCHS:
        model = build_model(_cfg(arch))
        net = model.with_mesh(mesh)
        cache = net.cache_defs(B_rows, max_len)["layers"]
        kinds = model.kinds[:len(model.cfg.block_pattern)]
        defs = model.param_defs()
        sh = param_shardings(mesh, model)

        def local(d, s):
            shape = list(d.shape)
            for i, pl in enumerate(s.placements):
                if pl.is_shard():
                    shape[pl.dim] //= mesh.size(i)
            return tuple(shape)
        out[arch] = dict(
            cache={k: {n: tuple(d.shape) for n, d in cache[i].items()}
                   for i, k in enumerate(kinds)},
            params={k: [local(d, s) for d, s in zip(
                leaves(defs["layers"][i]), leaves(sh["layers"][i]))]
                for i, k in enumerate(kinds)})
        assert all(isinstance(d, PSpec) for d in leaves(defs))
    return out


# ------------------------------------------------------------ rank bodies

def _rank(mesh, trees):
    """Every arch on this rank: the sharded run of its rows, its real
    param pieces, its cache pieces; recurrentgemma's window bounds of
    rank 0's segment at each decode step and a windowed prefill on the
    rank's heads against the one-device prefill's."""
    from repro_torch.dist import splitkv
    from repro_torch.dist.collective_ops import batch_rows
    from repro_torch.models import build_model, transformer_params_from_numpy
    from repro_torch.training.tree import leaves
    out = {}
    rows = batch_rows(mesh, B)
    real_bounds = splitkv.segment_bounds
    for arch in ARCHS:
        cfg = _cfg(arch)
        model = build_model(cfg)
        whole = transformer_params_from_numpy(cfg, trees[arch], "cpu")
        meshed = model.with_mesh(mesh)
        params = splitkv.partition_transformer_params(whole, meshed, mesh)
        prompt, toks = _inputs(cfg)
        bounds = []

        def seen(lengths, s0, seg, window):
            loc, start = real_bounds(lengths, s0, seg, window)
            bounds.append((s0, seg, loc.tolist(),
                           None if start is None else start.tolist()))
            return loc, start
        splitkv.segment_bounds = seen
        try:
            steps = _run(meshed, params, prompt, toks, rows)
        finally:
            splitkv.segment_bounds = real_bounds
        kinds = model.kinds[:len(cfg.block_pattern)]
        cache = meshed.cache_defs(rows.stop - rows.start, MAX_LEN)["layers"]
        out[arch] = dict(
            steps=steps, rows=(rows.start, rows.stop), bounds=bounds,
            dist=splitkv.supports_splitkv(model, mesh),
            cache={k: {n: tuple(d.shape) for n, d in cache[i].items()}
                   for i, k in enumerate(kinds)},
            params={k: [tuple(p.to_local().shape)
                        for p in leaves(params["layers"][i])]
                    for i, k in enumerate(kinds)})
    out["prefill_heads"] = _windowed_prefill(mesh)
    return out


def _windowed_prefill(mesh):
    """``splitkv.prompt_attention`` with the window, on the rank's q heads
    (one kv head, whole), against the one-device windowed prefill's heads
    of this rank: max |difference|."""
    from repro_torch.dist import splitkv
    from repro_torch.models import attention as A
    from repro_torch.models import build_model
    cfg = _cfg("recurrentgemma-9b")
    net = build_model(cfg).with_mesh(mesh)
    g = torch.Generator().manual_seed(4)
    H, D = cfg.num_heads, cfg.head_dim
    q = torch.randn(B, S, H, D, generator=g)
    k = torch.randn(B, S, 1, D, generator=g)
    v = torch.randn(B, S, 1, D, generator=g)
    hq = H // net.tp.n
    mine = q[:, :, net.tp.rank * hq:(net.tp.rank + 1) * hq]
    got = splitkv.prompt_attention(net, mine, k, v, causal=True,
                                   window=cfg.window)
    want = A.prefill_attention(q, k, v, window=cfg.window)
    want = want[:, :, net.tp.rank * hq:(net.tp.rank + 1) * hq]
    unwindowed = A.prefill_attention(q, k, v)[
        :, :, net.tp.rank * hq:(net.tp.rank + 1) * hq]
    return (float((got - want).abs().max()),
            float((want - unwindowed).abs().max()))


# ---------------------------------------------------------------- fixture

@pytest.fixture(scope="module")
def runs():
    """The reference's unsharded prefill and decode, the port's
    one-device run and both meshes' rank results (with the serve CLI on
    both archs, all at once)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import smoke_config as jsmoke
    from repro.models import build_model as jbuild
    from repro_torch.models import build_model, transformer_params_from_numpy
    jnets = {a: jbuild(jsmoke(a)) for a in ARCHS}
    jparams = {a: m.init(jax.random.key(0)) for a, m in jnets.items()}
    trees = {a: jax.tree.map(np.asarray, p) for a, p in jparams.items()}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    clis = {a: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", a,
         "--mesh", "1,2", "--device", "cpu", "--smoke", "--batch", "2",
         "--prompt-len", "12", "--gen", "4"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for a in ARCHS}
    with concurrent.futures.ThreadPoolExecutor(len(MESHES)) as pool:
        futs = {m: pool.submit(run_ranks, _rank, *m, args=(trees,))
                for m in MESHES}
        want = {}
        for arch in ARCHS:
            cfg = _cfg(arch)
            prompt, toks = _inputs(cfg)
            prefill = jax.jit(jnets[arch].prefill, static_argnums=(2,))
            decode = jax.jit(jnets[arch].decode_step)
            jl, jc = prefill(jparams[arch], jnp.asarray(prompt), MAX_LEN)
            js = [np.asarray(jl, np.float32)]
            for t in range(STEPS):
                jl, jc = decode(jparams[arch], jc,
                                jnp.asarray(toks[:, t:t + 1]),
                                jnp.asarray(_positions(t), jnp.int32))
                js.append(np.asarray(jl, np.float32))
            model = build_model(cfg)
            params = transformer_params_from_numpy(cfg, trees[arch], "cpu")
            want[arch] = dict(ref=js, port=_run(model, params, prompt, toks))
        ranks = {m: f.result() for m, f in futs.items()}
    cli = {a: (p.wait(timeout=600), p.stdout.read()) for a, p in clis.items()}
    return dict(want=want, ranks=ranks, cli=cli, jnets=jnets)


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_recurrent_decode_matches_reference(runs, mesh, arch):
    """Prefill and every decode step's logits on every rank's rows:
    within the reference's recurrent tolerance of its unsharded
    ``decode_step`` and within ``SELF_ATOL`` of the port's own."""
    want = runs["want"][arch]
    V = _cfg(arch).vocab_size
    for rk in runs["ranks"][mesh]:
        got = rk[arch]
        assert got["dist"]
        lo, hi = got["rows"]
        for t, g in enumerate(got["steps"]):
            np.testing.assert_allclose(g[..., :V], want["ref"][t][lo:hi, ..., :V],
                                       rtol=0, atol=REF_ATOL[arch],
                                       err_msg=str(t))
            np.testing.assert_allclose(g, want["port"][t][lo:hi], rtol=0,
                                       atol=SELF_ATOL[arch], err_msg=str(t))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_window_edge_inside_a_full_earlier_segment(runs, mesh):
    """Fault 1 of the windowed split-KV: at every decode step rank 0's
    segment is full (local length 24 = its rows) and the window's first
    key lies inside it (B14's ``start=`` 9-14, not 0); the logits of those
    steps match one device's (``test_sharded_recurrent_decode_matches_
    reference``). With the clamped local length alone, rank 0 would read
    the keys before the window."""
    seg = MAX_LEN // mesh[1]
    rk0 = runs["ranks"][mesh][0]["recurrentgemma-9b"]
    mine = [b for b in rk0["bounds"] if b[0] == 0]
    cfg = _cfg("recurrentgemma-9b")
    n_local = sum(cfg.block_pattern[i % len(cfg.block_pattern)]
                  == "attn_local" for i in range(cfg.num_layers))
    assert cfg.window == WINDOW and len(mine) == STEPS * n_local
    for s0, n, loc, start in mine:
        assert n == seg and all(x == seg for x in loc)
        assert all(0 < x < seg for x in start), start
    later = [b for rk in runs["ranks"][mesh] for b in
             rk["recurrentgemma-9b"]["bounds"] if b[0] > 0]
    assert later and all(all(x == 0 for x in b[3]) for b in later)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_windowed_prefill_on_rank_heads(runs, mesh):
    """Fault 2 of the windowed split-KV: the prefill's B15 on a rank's q
    heads takes the window (the prompt of 40 is past it), and equals the
    one-device windowed prefill's heads of that rank; without the window
    the heads differ by far more."""
    for rk in runs["ranks"][mesh]:
        err, moved = rk["prefill_heads"]
        assert err <= HEAD_ATOL and moved > 0.1, (err, moved)


def test_start_plain_version_merged_is_the_whole_window():
    """The plain B14 with ``start=`` on each segment's keys, at the bounds
    ``splitkv.segment_bounds`` gives (one segment wholly before every
    row's window, one holding its edge, one ragged), merged with the
    log-sum-exps, equals the whole windowed cache's attention; a segment
    wholly before the window gives 0 and -inf; without ``start=`` (the
    clamped local length alone) the merge reads keys before the window."""
    from repro_torch.dist.splitkv import merge, segment_bounds
    g = torch.Generator().manual_seed(1)
    Bq, Hq, Hkv, D, Sk, W, seg = 3, 4, 1, 16, 48, 20, 12
    q = torch.randn(Bq, Hq, D, generator=g)
    k = torch.randn(Bq, Hkv, Sk, D, generator=g)
    v = torch.randn(Bq, Hkv, Sk, D, generator=g)
    lengths = torch.tensor([33, 40, 47], dtype=torch.int32)
    whole = ref.decode_attention_window_ref(q, k, v, lengths, window=W)
    parts = {True: ([], []), False: ([], [])}
    for s0 in range(0, Sk, seg):
        loc, start = segment_bounds(lengths, s0, seg, W)
        for use in (True, False):
            lse = torch.empty(Bq, Hq)
            o = ref.decode_attention_window_ref(
                q, k[:, :, s0:s0 + seg], v[:, :, s0:s0 + seg], loc, lse=lse,
                start=start if use else None)
            parts[use][0].append(o)
            parts[use][1].append(lse)
            if use and s0 == 0:            # wholly before the window
                assert (start == seg).all() and not o.any()
                assert torch.isneginf(lse).all()
    got = merge(torch.stack(parts[True][0]), torch.stack(parts[True][1]))
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=0, atol=1e-6)
    wrong = merge(torch.stack(parts[False][0]), torch.stack(parts[False][1]))
    assert (wrong - whole).abs().max() > 0.05


def test_start_composes_with_window_and_lse():
    """``ops.decode_attention``'s plain version with ``start=`` and
    ``window=`` together keeps keys in [max(start, len - window), len);
    a row whose start is at or past its length gives 0 and lse -inf;
    ``start`` of zeros is the launch without it."""
    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(2)
    Bq, Hq, Hkv, D, Sk = 4, 4, 2, 16, 30
    q = torch.randn(Bq, Hq, D, generator=g)
    k = torch.randn(Bq, Hkv, Sk, D, generator=g)
    v = torch.randn(Bq, Hkv, Sk, D, generator=g)
    n = torch.tensor([30, 25, 10, 7], dtype=torch.int32)
    start = torch.tensor([5, 20, 10, 0], dtype=torch.int32)
    lse = torch.empty(Bq, Hq)
    o = ops.decode_attention(q, k, v, n, window=8, start=start, lse=lse,
                             backend="ref")
    for b in range(Bq):
        lo = max(int(start[b]), int(n[b]) - 8)
        if lo >= n[b]:
            assert not o[b].any() and torch.isneginf(lse[b]).all()
            continue
        sub = ref.decode_attention_window_ref(
            q[b:b + 1], k[b:b + 1, :, lo:int(n[b])],
            v[b:b + 1, :, lo:int(n[b])], n[b:b + 1] - lo)
        np.testing.assert_allclose(o[b:b + 1].numpy(), sub.numpy(), rtol=0,
                                   atol=1e-6)
    zero = torch.zeros(Bq, dtype=torch.int32)
    assert torch.equal(ops.decode_attention(q, k, v, n, start=zero,
                                            backend="ref"),
                       ops.decode_attention(q, k, v, n, backend="ref"))


def _ref_shards(jnets, mesh, B_glob, max_len):
    """The reference's shard shapes (``resolve_spec`` over each leaf's
    logical axes and global shape) of each arch's per-kind cache and
    block params on ``mesh``'s axes."""
    from repro.sharding import resolve_spec
    names = mesh.mesh_dim_names
    jmesh = types.SimpleNamespace(axis_names=names,
                                  devices=np.empty(mesh.shape))
    sizes = dict(zip(names, mesh.shape))

    def shard(d):
        spec = resolve_spec(jmesh, d.axes, d.shape)
        out = list(d.shape)
        for i, e in enumerate(tuple(spec) + (None,) * len(d.shape)):
            if i >= len(out) or e is None:
                continue
            for ax in ((e,) if isinstance(e, str) else e):
                out[i] //= sizes[ax]
        return tuple(out)
    from jax import tree_util

    def named(tree):          # the reference nests a layer's state in "mix"
        return {n: v for k, d in tree.items() for n, v in
                (named(d).items() if isinstance(d, dict) else [(k, d)])}
    out = {}
    for arch in ARCHS:
        net = jnets[arch]
        kinds = net.cfg.block_pattern
        is_leaf = lambda x: hasattr(x, "axes") and hasattr(x, "shape")
        out[arch] = dict(
            cache={k: {n: shard(d) for n, d in named(
                net._cache_defs_block(k, B_glob, max_len)).items()}
                   for k in kinds},
            params={k: [shard(d) for d in tree_util.tree_leaves(
                net._block_defs(k), is_leaf=is_leaf)] for k in kinds})
    return out


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_rank_pieces_equal_reference_shard_shapes(runs, mesh):
    """Every rank's cache pieces (``cache_defs`` under the mesh: the
    attention segment, RG-LRU's ``h`` / ``conv`` on its ``d_rnn`` slice,
    RWKV6's ``S`` on its heads, ``x_tm`` / ``x_cm`` whole) and its real
    param pieces equal the reference's shard shapes."""
    want = _ref_shards(runs["jnets"], FakeMesh(("data", "model"), mesh), B,
                       MAX_LEN)
    for rk in runs["ranks"][mesh]:
        for arch in ARCHS:
            assert rk[arch]["cache"] == want[arch]["cache"], arch
            assert rk[arch]["params"] == want[arch]["params"], arch


@pytest.mark.parametrize("name", sorted(PROD_MESHES))
def test_production_pieces_equal_reference_shard_shapes(runs, name):
    """On pod16x16 and pod2x16x16, rank 0's decode_32k cache pieces (128
    rows over the batch axes) and block param pieces equal the
    reference's shard shapes."""
    mesh = PROD_MESHES[name]
    rows = 128 // int(np.prod(mesh.shape[:-1]))
    want = _ref_shards(runs["jnets"], mesh, 128, 32768)
    got = _pieces(mesh, rows, 32768)
    for arch in ARCHS:
        assert got[arch]["cache"] == want[arch]["cache"], arch
        assert got[arch]["params"] == want[arch]["params"], arch


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_mesh_recurrent(runs, arch):
    """``launch.serve --arch ARCH --smoke --mesh 1,2 --device cpu`` serves
    the recurrent families end to end on two spawned ranks."""
    rc, text = runs["cli"][arch]
    assert rc == 0, text[-3000:]
    assert "mesh: data=1 model=2 over 2 ranks, gloo" in text
    assert "this rank's pieces" in text
    assert "generated (2, 4)" in text

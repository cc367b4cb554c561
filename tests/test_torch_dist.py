"""Sharded packed BRDS-LSTM decode (``repro_torch.dist``) on gloo CPU ranks.

The reference's ``tests/test_dist.py`` holds sharded decode bitwise equal
to single-device decode of each data group's sub-batch; these tests hold
the port to the same, at the reference's small widths (X=16, H=64, 2
layers, V=50) on meshes (1, 2), (2, 2) and (1, 4): ``ServeEngine(mesh=)``
on the packed, Θ=0 / Θ>0 / capped delta, calibrated int8 and delta + int8
policies, every rank's tokens and logits bitwise the port's single-device
chained decode of its data group, and the tokens those of the live JAX
reference's single-device decode (logits within ``LOGIT_ATOL``). Also: the
sharded kernel wrappers bitwise the unsharded ops, the partition contract
and its validation errors, the collective inventory (``num_layers``
all-gathers a decode step), sampled decode against the group's run at the
same seed, the scheduler on a mesh against per-request single-device
decode, and ``launch.serve --mesh``.

Each mesh's ranks start once (``launch.mesh.run_ranks``, a module-scoped
fixture) and run every scenario of the group; the rank functions live in
this module and import neither JAX nor the reference.
"""
import concurrent.futures
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import run_ranks

KW = dict(input_size=16, hidden=64, num_layers=2, vocab_size=50)
B, PROMPT, GEN, MAX_LEN = 4, 7, 6, 20
LOGIT_ATOL = 1e-5   # tests/test_torch_serve.py: float32 sums in another order
POLICIES = ("packed", "delta0", "delta+", "delta_cap", "q8", "delta_q8")
MESHES = [(1, 2), (2, 2), (1, 4)]
REPO = os.path.join(os.path.dirname(__file__), "..")


def _policy(S, name):
    """``name``'s policy built from ``S`` (``repro.sparse`` or
    ``repro_torch.sparse``)."""
    d0 = lambda: S.DeltaGateConfig()
    return {
        "packed": lambda: S.lstm_policy(0.75, 0.5),
        "delta0": lambda: S.lstm_policy(0.75, 0.5, delta=d0()),
        "delta+": lambda: S.lstm_policy(
            0.75, 0.5, delta=S.DeltaGateConfig(0.05, 0.02)),
        "delta_cap": lambda: S.lstm_policy(0.75, 0.5, delta=S.DeltaGateConfig(
            0.05, 0.05, cap_x=0.5, cap_h=0.5)),
        "q8": lambda: S.lstm_policy(0.75, 0.5,
                                    quant=S.QuantConfig("int8")),
        "delta_q8": lambda: S.lstm_policy(0.75, 0.5, delta=d0(),
                                          quant=S.QuantConfig("int8")),
    }[name]()


def _inputs():
    rng = np.random.default_rng(1)
    return (rng.integers(0, KW["vocab_size"], (B, PROMPT)),
            rng.integers(0, KW["vocab_size"], (2, 6)))   # prompt, calib


# ------------------------------------------------------------ rank bodies

def _port(params_np):
    from repro_torch.models import LSTMConfig, LSTMModel, params_from_numpy
    return LSTMModel(LSTMConfig("t", **KW)), params_from_numpy(params_np,
                                                                "cpu")


def _serve(mesh, model, params, name, prompt, calib, **gen):
    """(tokens, state) of ``name``'s policy served with ``mesh`` (None:
    one device, the chained path)."""
    import repro_torch.sparse as S
    from repro_torch.serving import ServeEngine
    if mesh is None:
        model = model.with_fused(False)
    eng = ServeEngine(model, max_len=MAX_LEN, sparsity=_policy(S, name),
                      device="cpu", mesh=mesh)
    p, _ = eng.prepare(params, calib=torch.as_tensor(
        calib) if name.endswith("q8") else None)
    if mesh is not None:
        assert eng._dist and eng.model.mesh is mesh
        assert not eng.model._use_fused
    toks, st = eng.generate(p, torch.as_tensor(prompt), GEN,
                            return_state=True, **gen)
    return eng, p, toks, st


def _decode_rank(mesh, params_np, prompt, calib):
    """Every policy sharded and a sampled run; on the first rank of each
    model group, the single-device chained decode of the data group's
    rows, which the other ranks of the group share."""
    from repro_torch.dist.collective_ops import batch_rows
    model, params = _port(params_np)
    rows = batch_rows(mesh, B)
    lead = mesh.get_local_rank("model") == 0
    out = {"rows": (rows.start, rows.stop), "lead": lead}
    for name in POLICIES:
        _, _, toks, st = _serve(mesh, model, params, name, prompt, calib)
        out[name] = dict(toks=toks.numpy(), logits=st["logits"].numpy())
        if lead:
            _, _, gt, gs = _serve(None, model, params, name, prompt[rows],
                                  calib)
            out[name].update(group_toks=gt.numpy(),
                             group_logits=gs["logits"].numpy())
    samp = {}
    for m in (mesh, None) if lead else (mesh,):
        p = prompt if m is not None else prompt[rows]
        _, _, t, _ = _serve(m, model, params, "packed", p, calib,
                            temperature=1.0,
                            rng=torch.Generator().manual_seed(5))
        samp["mesh" if m is not None else "group"] = t.numpy()
    out["sampled"] = samp
    out["inventory"] = _inventory(mesh, model, params, prompt, calib)
    return out


def _inventory(mesh, model, params, prompt, calib):
    """The collective inventory of one decode step, float and delta +
    int8."""
    from repro_torch.obs import collectives
    inv = {}
    for name in ("packed", "delta_q8"):
        eng, p, _, st = _serve(mesh, model, params, name, prompt, calib)
        B_local = st["cache"]["layers"][0]["h"].shape[0]
        tok = torch.zeros((B_local, 1), dtype=torch.long)
        inv[name] = collectives.summarize_inventory(
            collectives.decode_step_inventory(eng.model, p, st["cache"], tok,
                                              PROMPT))
    return inv


def _kernel_rank(mesh, params_np, prompt, calib):
    """The sharded kernel wrappers against the unsharded ops, the partition
    contract, its validation errors and the collective inventory."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch import dist
    from repro_torch.core.packing import pack_from_dense
    from repro_torch.kernels import ops as K
    from repro_torch.quant import quantize_packed
    from repro_torch.serving import ContinuousBatchingEngine, ServeEngine
    import repro_torch.sparse as S

    g = torch.Generator().manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=g)
    sx, sh = pack_from_dense(rnd(256, 48), 0.75), pack_from_dense(
        rnd(256, 64), 0.5)
    x, h, b, m = rnd(4, 48), rnd(4, 64), rnd(256), rnd(4, 256)
    fx, fh = x.abs() > 0.5, h.abs() > 0.5
    qx, qh = quantize_packed(sx, "int8"), quantize_packed(sh, "int8")
    out = {"kernels": {
        "float": bool(torch.equal(
            K.rb_dual_spmv(sx, x, sh, h, b),
            dist.sharded_rb_dual_spmv(mesh, sx, x, sh, h, b))),
        "delta": bool(torch.equal(
            K.delta_rb_dual_spmv(sx, x, fx, sh, h, fh, m),
            dist.sharded_delta_rb_dual_spmv(mesh, sx, x, fx, sh, h, fh, m))),
        "q8": bool(torch.equal(
            K.rb_dual_spmv_q8(qx, x, qh, h, b),
            dist.sharded_rb_dual_spmv_q8(mesh, qx, x, qh, h, b)))}}

    model, params = _port(params_np)
    plan = S.lstm_policy(0.5, 0.5).compile(params)
    packed, _ = plan.pack(*plan.prune(params))
    pp = dist.partition_lstm_params(packed, mesh)
    w = pp["layers"][0]["w_x"]
    out["partition"] = dict(
        same_keys=[sorted(lp) for lp in pp["layers"]]
        == [sorted(lp) for lp in packed["layers"]],
        same_types=all(isinstance(pp["layers"][i][k], type(lp[k]))
                       for i, lp in enumerate(packed["layers"]) for k in lp),
        dtensor=isinstance(w.values, DTensor),
        placements=tuple(w.values.placements) == (Replicate(), Shard(0)),
        local_rows=w.values.to_local().shape[0], rows=w.rows,
        embed_plain=not isinstance(pp["embed"]["table"], DTensor))
    dist.check_partitioned(pp, mesh)

    errors = {}

    def expect(key, exc, fn):
        try:
            fn()
        except exc as e:
            errors[key] = str(e)

    expect("not_packed", ValueError, lambda: dist.partition_lstm_params(
        {"layers": [{"w_x": 1}]}, mesh))
    expect("hidden", ValueError, lambda: dist.partition_lstm_params(
        {"layers": [{"w_x": pack_from_dense(rnd(24, 8), 0.5)}]}, mesh))
    expect("permutation", ValueError,
           lambda: dist.gate_row_permutation(30, 4))
    expect("scheduler", ValueError, lambda: ContinuousBatchingEngine(
        model, packed, slots=2, max_len=16, mesh=mesh, device="cpu"))
    expect("generate", ValueError, lambda: ServeEngine(
        model.with_mesh(mesh), max_len=16, device="cpu").generate(
        packed, torch.as_tensor(prompt[:2, :4]), 2))
    expect("dense", ValueError, lambda: model.with_mesh(mesh).prefill(
        params, torch.as_tensor(prompt[:2, :4]), 16))
    expect("draft", ValueError, lambda: ContinuousBatchingEngine(
        model, pp, mesh=mesh, draft=object(), device="cpu"))
    out["errors"] = errors
    return out


def _sched_rank(mesh, params_np, reqs):
    """The scheduler on ``mesh`` over ragged requests, and each request's
    single-device batch-1 decode."""
    import repro_torch.sparse as S
    from repro_torch.serving import ContinuousBatchingEngine, ServeEngine
    model, params = _port(params_np)
    eng = ServeEngine(model, max_len=24, sparsity=_policy(S, "packed"),
                      device="cpu", mesh=mesh)
    packed, _ = eng.prepare(params)
    sched = ContinuousBatchingEngine(eng.model, packed, slots=2, max_len=24,
                                     chunk=4, mesh=mesh, device="cpu")
    uids = [sched.submit(p, n) for p, n in reqs]
    got = sched.run()
    assert sched.pending == 0 and not sched.active_slots
    ref = ServeEngine(model, max_len=24, sparsity=_policy(S, "packed"),
                      device="cpu")
    rp, _ = ref.prepare(params)
    want = [ref.generate(rp, torch.as_tensor(p), n)[0].numpy()
            for p, n in reqs]
    return dict(got=[got[u] for u in uids], want=want,
                local_slots=sched._local)


def _group_rank(mesh, params_np, prompt, calib, reqs):
    out = _decode_rank(mesh, params_np, prompt, calib)
    if mesh.shape == (1, 4):
        out.update(_kernel_rank(mesh, params_np, prompt, calib))
    if mesh.shape == (2, 2):
        out["sched"] = _sched_rank(mesh, params_np, reqs)
    return out


# ---------------------------------------------------------------- fixtures

@pytest.fixture(scope="module")
def ref():
    """The JAX reference's weights, inputs and single-device decode of
    every policy, and every mesh's rank results: the three meshes' ranks
    run at once, beside the reference's decode."""
    import jax
    from repro.models import LSTMConfig as JConfig, LSTMModel as JModel
    from repro.serving import ServeEngine as JEngine
    import repro.sparse as JS
    jmodel = JModel(JConfig("t", **KW))
    jparams = jmodel.init(jax.random.key(0))
    params = jax.tree.map(np.asarray, jparams)
    prompt, calib = _inputs()
    g = np.random.default_rng(7)
    reqs = [(g.integers(0, KW["vocab_size"], (1, n)), gen)
            for n, gen in ((5, 6), (9, 3), (3, 7), (7, 5))]
    with concurrent.futures.ThreadPoolExecutor(len(MESHES)) as pool:
        runs = {m: pool.submit(run_ranks, _group_rank, *m,
                               args=(params, prompt, calib, reqs))
                for m in MESHES}
        out = {}
        with JS.use_backend("ref"):
            for name in POLICIES:
                eng = JEngine(jmodel, JConfig("t", **KW), max_len=MAX_LEN,
                              batch=B, sparsity=_policy(JS, name))
                p, _ = eng.prepare(jparams, calib=calib if name.endswith(
                    "q8") else None)
                toks, st = eng.generate(p, prompt, GEN, return_state=True)
                out[name] = (np.asarray(toks), np.asarray(st["logits"]))
        runs = {m: f.result() for m, f in runs.items()}
    return dict(jax=out, runs=runs)


def _ranks(ref, mesh):
    return ref["runs"][mesh]


def _lead(runs, r):
    """The first rank of ``r``'s model group (its data group's rows)."""
    return next(q for q in runs if q["lead"] and q["rows"] == r["rows"])


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("name", POLICIES)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_generate_bitwise_single_device(ref, mesh, name):
    """Every rank's tokens (gathered over data: the whole batch) and
    logits equal, on its data group's rows, the single-device chained
    decode of that group's sub-batch, bit for bit; all ranks agree."""
    runs = _ranks(ref, mesh)
    for r in runs:
        lo, hi = r["rows"]
        got, want = r[name], _lead(runs, r)[name]
        assert got["toks"].shape == (B, GEN)
        np.testing.assert_array_equal(got["toks"][lo:hi], want["group_toks"])
        np.testing.assert_array_equal(got["logits"][lo:hi],
                                      want["group_logits"])
        np.testing.assert_array_equal(got["toks"], runs[0][name]["toks"])
        np.testing.assert_array_equal(got["logits"],
                                      runs[0][name]["logits"])


@pytest.mark.parametrize("name", POLICIES)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_generate_matches_jax(ref, mesh, name):
    """The sharded tokens are the live JAX reference's single-device
    tokens; the logits within ``LOGIT_ATOL``."""
    got = _ranks(ref, mesh)[0][name]
    jtoks, jlogits = ref["jax"][name]
    np.testing.assert_array_equal(got["toks"], jtoks)
    np.testing.assert_allclose(got["logits"], jlogits, rtol=0,
                               atol=LOGIT_ATOL)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_sampling_matches_group(ref, mesh):
    """At temperature 1 every rank of a model group draws alike from a
    generator seeded alike: the draws are the single-device run's of the
    group's sub-batch at the same seed."""
    runs = _ranks(ref, mesh)
    for r in runs:
        lo, hi = r["rows"]
        np.testing.assert_array_equal(r["sampled"]["mesh"][lo:hi],
                                      _lead(runs, r)["sampled"]["group"])


@pytest.mark.parametrize("kind", ["float", "delta", "q8"])
def test_sharded_kernel_wrappers_bitwise(ref, kind):
    """sharded_rb_dual_spmv / sharded_delta_rb_dual_spmv /
    sharded_rb_dual_spmv_q8 over 4 ranks equal the unsharded ops."""
    assert all(r["kernels"][kind] for r in _ranks(ref, (1, 4)))


def test_partition_contract(ref):
    """The partitioned tree keeps the packed tree's structure; each rank's
    packed rows are a DTensor (replicated over data, sharded over model)
    holding 4H/4 rows of the 4H; embed and head stay plain."""
    for r in _ranks(ref, (1, 4)):
        p = r["partition"]
        assert p["same_keys"] and p["same_types"] and p["dtensor"]
        assert p["placements"] and p["embed_plain"]
        assert (p["local_rows"], p["rows"]) == (64, 256)


@pytest.mark.parametrize("key,match", [
    ("not_packed", "SparsityPlan.pack"), ("hidden", "not divisible"),
    ("permutation", "not divisible"), ("scheduler", "not dist-partitioned"),
    ("generate", "not dist-partitioned"), ("dense", "partitioned packed"),
    ("draft", "speculative")])
def test_partition_validation(ref, key, match):
    """Packed params that were not partitioned raise before they decode
    (generate and the scheduler), as do dense params on a meshed model, a
    draft on a mesh, and shapes the mesh does not divide."""
    for r in _ranks(ref, (1, 4)):
        assert match in r["errors"][key]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_collective_inventory(ref, mesh):
    """One decode step issues exactly num_layers all-gathers, each of the
    rank's (B / data) × (H / model) float32 hidden slice, and no other
    collective: no gather over data inside a step."""
    d, m = mesh
    for r in _ranks(ref, mesh):
        for name, inv in r["inventory"].items():
            assert inv["counts"] == {"all-gather": KW["num_layers"]}, name
            assert inv["wire_bytes"] == (KW["num_layers"] * (B // d)
                                         * (KW["hidden"] // m) * 4), name


def test_scheduler_on_mesh_matches_single_device(ref):
    """The scheduler on a (2, 2) mesh (one slot a data group) serves every
    request its single-device batch-1 tokens."""
    for r in _ranks(ref, (2, 2)):
        s = r["sched"]
        assert s["local_slots"] == 1
        for got, want in zip(s["got"], s["want"]):
            np.testing.assert_array_equal(got, want)


def test_cli_mesh():
    """``launch.serve --mesh 1,2 --device cpu --dist-backend gloo`` spawns
    its ranks and serves; rank 0 prints."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "lstm_ptb", "--brds", "--smoke", "--mesh", "1,2", "--device", "cpu",
         "--dist-backend", "gloo", "--batch", "2", "--prompt-len", "8",
         "--gen", "4"], capture_output=True, text=True, env=env,
        timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "mesh: data=1 model=2 over 2 ranks, gloo" in out.stdout
    assert out.stdout.count("generated (2, 4)") == 1

"""The accuracy loop in the port (``repro_torch.launch.pipeline``) against
the reference's (``repro.launch.pipeline``) on the CPU: the task and its
batches, ``evaluate`` on JAX-trained params carried across at all four
deployments (fp32 / int8 × Θ 0 / 0.05), bitwise serving parity and its
detection of a changed deployment, the CLI's gate, and one ``--smoke
--gate 5`` run of each package end to end (shared by the tests below),
the port's held to the BENCH schema."""
import importlib.util
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.launch import pipeline as jpl
from repro.models import LSTMModel as JModel
from repro_torch.launch import pipeline as pl
from repro_torch.models import LSTMModel, params_from_numpy

REPO = os.path.join(os.path.dirname(__file__), "..")
# nll of the same deployment on the same params: float32 sums over 16
# steps in another order (fp32, measured 1.1e-7 relative); int8 codes and
# Θ=0.05 decisions can flip on a last-bit difference (measured ≤ 2.1e-7)
NLL_RTOL = {("fp32", 0.0): 1e-6, ("fp32", 0.05): 1e-5,
            ("int8", 0.0): 1e-5, ("int8", 0.05): 1e-5}
# the two smoke runs start from different seeded inits (torch's generator,
# JAX's key): their perplexities agree as statistics only (measured ≤ 0.8%)
SMOKE_PPL_RTOL = 0.03


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # many tiny ops: torch's intra-op threads only contend here
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _schema_checker():
    spec = importlib.util.spec_from_file_location(
        "check_bench_schema",
        os.path.join(REPO, "scripts", "check_bench_schema.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def smoke_runs(tmp_path_factory):
    """One ``--smoke --gate 5`` run of each package (the port's through
    its CLI on the CPU, a process of its own on one torch thread, while
    the reference's runs here): (port payload, port exit code, JAX
    payload)."""
    out = tmp_path_factory.mktemp("bench")
    port = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.pipeline", "--smoke",
         "--gate", "5", "--device", "cpu", "--out", str(out)],
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1",
                           PYTHONPATH=os.path.join(REPO, "src")),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        jpayload = jpl.run_pipeline(jpl.PipelineConfig(), smoke=True,
                                    log=lambda *_: None)
        text, _ = port.communicate(timeout=900)
    finally:
        if port.poll() is None:
            port.kill()
            port.wait()
    assert (out / "BENCH_pipeline.json").exists(), text[-3000:]
    payload = json.loads((out / "BENCH_pipeline.json").read_text())
    return payload, port.returncode, jpayload


@pytest.fixture(scope="module")
def carried():
    """A JAX-trained smoke LSTM (40 dense steps, then 20 masked retrain
    steps at (0.75, 0.5)) carried across with ``params_from_numpy``."""
    cfg = jpl.PipelineConfig(train_steps=40)
    corpus, jlcfg = jpl.build_task(cfg)
    jmodel = JModel(jlcfg)
    dense, _ = jpl.train_lstm(jmodel, corpus, cfg, steps=40, lr=cfg.lr)
    plan = jpl._policy_at(cfg, 0.75, 0.5, None, 0.0).compile(dense)
    pruned, masks = plan.prune(dense)
    jparams, _ = jpl.train_lstm(jmodel, corpus, cfg, steps=20,
                                lr=cfg.retrain_lr, params=pruned,
                                masks=masks)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    tcfg = pl.PipelineConfig(train_steps=40, device="cpu")
    _, lcfg = pl.build_task(tcfg)
    return dict(jcfg=cfg, cfg=tcfg, corpus=corpus, jlcfg=jlcfg, lcfg=lcfg,
                jmodel=jmodel, jparams=jparams, params=params,
                eval_set=corpus.eval_batches(2, 8, 16),
                gen_raw=corpus.batch(1 << 42, 4, 16))


# ------------------------------------------------------------ the pieces

@pytest.mark.parametrize("corpus", ["char", "zipf", "frame"])
def test_build_task_matches(corpus):
    cfg = pl.PipelineConfig(corpus=corpus)
    ours, lcfg = pl.build_task(cfg)
    ref, jlcfg = jpl.build_task(jpl.PipelineConfig(corpus=corpus))
    for f in ("name", "input_size", "hidden", "num_layers", "vocab_size",
              "num_classes", "framewise"):
        assert getattr(lcfg, f) == getattr(jlcfg, f)
    for a, b in zip(ours.eval_batches(2, 4, 8), ref.eval_batches(2, 4, 8)):
        tb, jb = pl._as_model_batch(a), jpl._as_model_batch(b)
        for k in ("inputs", "labels"):
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    with pytest.raises(ValueError):
        pl.build_task(pl.PipelineConfig(corpus="imagenet"))


def test_score_matches_loss_on_dense_lm():
    """The serving-path scorer computes the training loss on dense params:
    the quantity the gate reads is the one training optimized."""
    cfg = pl.PipelineConfig(device="cpu")
    corpus, lcfg = pl.build_task(cfg)
    model = LSTMModel(lcfg)
    params = model.init(device="cpu")
    b = pl._as_model_batch(corpus.batch(7, 4, 12))
    with torch.no_grad():
        np.testing.assert_allclose(
            float(model.score(params, b["inputs"], b["labels"])),
            float(model.loss(params, b)), rtol=1e-5)
    out = pl.evaluate(model, params, corpus.eval_batches(2, 4, 8))
    np.testing.assert_allclose(out["ppl"], np.exp(out["nll"]), rtol=1e-6)


def test_parse_grid_and_mesh():
    assert pl._parse_grid("0.75:0.5,0.875:0.625") == ((0.75, 0.5),
                                                      (0.875, 0.625))
    # the sharded pipeline runs in tests/test_torch_sharded_train.py; a
    # malformed --mesh stops before any rank starts
    for bad in ("2,x", "0,2", "2"):
        with pytest.raises(SystemExit):
            pl.main(["--smoke", "--device", "cpu", "--mesh", bad])


def test_cli_gate_semantics(monkeypatch, tmp_path):
    """--gate fails the process (exit 1) past the primary point's ppl
    delta, passes under it, and a negative gate disables it — as the
    reference's CLI does on the same payload."""
    fake = {"benchmark": "pipeline", "smoke": True, "wall_time_s": 0.1,
            "rows": [], "gate": {"spar_x": 0.75, "spar_h": 0.5,
                                 "ppl_dense": 1.2, "ppl_sparse": 1.32,
                                 "ppl_delta_pct": 10.0}}
    seen = []
    monkeypatch.setattr(pl, "run_pipeline",
                        lambda cfg, smoke: seen.append(cfg) or fake)
    monkeypatch.setattr(jpl, "run_pipeline", lambda cfg, smoke: fake)
    argv = ["--smoke", "--out", str(tmp_path)]
    for gate in ("5", "15", "-1"):
        assert pl.main(argv + ["--gate", gate]) == \
            jpl.main(argv + ["--gate", gate])
    assert pl.main(argv + ["--gate", "5"]) == 1
    payload = json.loads((tmp_path / "BENCH_pipeline.json").read_text())
    assert payload["gate"]["ppl_delta_pct"] == 10.0
    # the CLI's overrides give the reference's config, device aside
    jseen = []
    monkeypatch.setattr(jpl, "run_pipeline",
                        lambda cfg, smoke: jseen.append(cfg) or fake)
    full = ["--out", str(tmp_path), "--grid", "0.5:0.25", "--layers", "2",
            "--theta", "0.1", "--lr", "0.01"]
    pl.main(full + ["--device", "cpu"])
    jpl.main(full)
    ours = {k: v for k, v in vars(seen[-1]).items() if k != "device"}
    assert ours == vars(jseen[-1])
    assert seen[-1].device == "cpu"


# ----------------------------------------------------- carried-across params

@pytest.mark.parametrize("scheme", [None, "int8"], ids=["fp32", "int8"])
@pytest.mark.parametrize("theta", [0.0, 0.05])
def test_evaluate_carried_params(carried, scheme, theta):
    """One deployment of JAX-trained params: the port's ``run_point``
    (served nll bitwise the manual one) against the reference's manual
    deployment and ``evaluate``, and the same weight bytes."""
    c = carried
    calib_raw = c["corpus"].batch(1 << 41, 8, 16)
    calib = pl._as_model_batch(calib_raw)["inputs"]
    jcalib = jpl._as_model_batch(calib_raw)["inputs"]
    point = pl.run_point(LSTMModel(c["lcfg"]), c["lcfg"], c["params"],
                         c["cfg"], 0.75, 0.5, scheme, theta, c["eval_set"],
                         calib, c["gen_raw"])
    policy = jpl._policy_at(c["jcfg"], 0.75, 0.5, scheme, theta)
    jm, jpacked, jrep = jpl.prepare_manual(JModel(c["jlcfg"]), policy,
                                           c["jparams"],
                                           calib=jcalib if scheme else None)
    want = jpl.evaluate(jm, jpacked, c["eval_set"])
    np.testing.assert_allclose(point["metrics"]["nll"], want["nll"],
                               rtol=NLL_RTOL[(scheme or "fp32", theta)])
    assert point["weight_bytes"] == jrep["packed_bytes"]
    assert point["dense_bytes"] == jrep["dense_bytes"]
    assert point["toks_per_s"] > 0


def test_serving_parity_detects_quality_change(carried):
    """The parity check fires: a manual route deploying at a harsher
    Spar_x than the engine gives another nll, and run_point raises."""
    c = carried
    orig = pl.prepare_manual

    def skewed(model, policy, params, calib=None):
        return orig(model, pl._policy_at(c["cfg"], 0.9, 0.5, None, 0.0),
                    params, calib=calib)

    pl.prepare_manual = skewed
    try:
        with pytest.raises(pl.PipelineError, match="changed quality"):
            pl.run_point(LSTMModel(c["lcfg"]), c["lcfg"], c["params"],
                         c["cfg"], 0.75, 0.5, None, 0.0, c["eval_set"],
                         None, c["gen_raw"])
    finally:
        pl.prepare_manual = orig


def test_train_lstm_matches_from_the_same_init(carried):
    """Dense training from the reference's init: the port's ``train_lstm``
    ends within float noise of the reference's after 10 steps."""
    c = carried
    jmodel = c["jmodel"]
    jinit = jmodel.init(jax.random.key(0))
    jout, jloss = jpl.train_lstm(jmodel, c["corpus"], c["jcfg"], steps=10,
                                 lr=c["jcfg"].lr)
    out, loss = pl.train_lstm(
        LSTMModel(c["lcfg"]), c["corpus"], c["cfg"], steps=10,
        lr=c["cfg"].lr,
        params=params_from_numpy(jax.tree.map(np.asarray, jinit), "cpu"))
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    for a, b in zip(jax.tree.leaves(jout),
                    [out["embed"]["table"], out["head"]["w"],
                     out["layers"][0]["b"], out["layers"][0]["w_h"],
                     out["layers"][0]["w_x"]]):
        # measured ≤ 1.2e-7 after 10 AdamW steps at lr 5e-3
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-6)


def test_frame_corpus_classifier_loop():
    """The TIMIT stand-in (framewise classifier) closes the same loop:
    accuracy through the dense forward, parity bitwise at 4 points."""
    cfg = pl.PipelineConfig(corpus="frame", train_steps=20, retrain_steps=10,
                            spar_grid=((0.75, 0.5),), eval_batches=2,
                            device="cpu")
    payload = pl.run_pipeline(cfg, smoke=True, log=lambda *_: None)
    rows = {r["name"]: r for r in payload["rows"]}
    assert rows["pipeline_serve_parity"] == {
        "name": "pipeline_serve_parity", "us_per_call": 0.0, "bitwise": 1,
        "points": 4}
    assert 0.0 <= rows["pipeline_dense"]["acc"] <= 1.0


# --------------------------------------------------------- the whole arc

def test_smoke_run_passes_gate_and_schema(smoke_runs):
    """``--smoke --gate 5``: exit 0, the gate's delta within 5% at
    (0.75, 0.5), parity bitwise at all 8 points, the BENCH schema."""
    payload, rc, _ = smoke_runs
    assert rc == 0
    assert payload["gate"]["ppl_delta_pct"] <= 5.0
    rows = {r["name"]: r for r in payload["rows"]}
    assert rows["pipeline_serve_parity"]["bitwise"] == 1
    assert rows["pipeline_serve_parity"]["points"] == 8
    _schema_checker().check_pipeline("payload", payload)


def test_smoke_run_matches_reference(smoke_runs):
    """Row for row against the reference's smoke run: the same names,
    weight bytes and compression (set by the shapes and ratios), and
    perplexities within ``SMOKE_PPL_RTOL`` (different inits)."""
    payload, _, jpayload = smoke_runs
    assert [r["name"] for r in payload["rows"]] == \
        [r["name"] for r in jpayload["rows"]]
    for r, j in zip(payload["rows"], jpayload["rows"]):
        for k in ("weight_bytes", "compression", "spar_x", "spar_h",
                  "theta", "scheme", "bitwise", "points"):
            assert r.get(k) == j.get(k), (r["name"], k)
        if "ppl" in r:
            np.testing.assert_allclose(r["ppl"], j["ppl"],
                                       rtol=SMOKE_PPL_RTOL, err_msg=r["name"])
    assert payload["gate"].keys() == jpayload["gate"].keys()

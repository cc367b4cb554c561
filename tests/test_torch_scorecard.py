"""The rest of the port's observability on the CPU against the reference:
``repro_torch.hw`` (the H100's constants), ``obs.metrics`` (the same
observations give the reference's Prometheus text and JSON),
``obs.scorecard`` (the same packed lstm_ptb tree and counters give the
reference's ledger; the fields that read ``hw`` are recomputed from the
H100's constants), ``roofline``'s analytic functions (equal to the
reference's for every arch the port builds), the serving package's
public names, the serve CLI's ``--metrics`` / ``--scorecard``, and the
port's isolation from JAX and the reference package."""
import json
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import roofline as j_roofline
from repro import serving as j_serving
from repro.configs import SHAPES as J_SHAPES, get_arch as j_get_arch
from repro.models import LSTM_CONFIGS as J_LSTM_CONFIGS
from repro.models import LSTMModel as JLSTMModel
from repro.obs import metrics as JM
from repro.obs import scorecard as JS
from repro.traffic import RequestRecord as JRecord, summarize as j_summarize
from repro_torch import hw, roofline
from repro_torch import serving
from repro_torch.configs import ARCH_NAMES, SHAPES, get_arch
from repro_torch.models import LSTM_CONFIGS, build_model, params_from_numpy
from repro_torch.obs import metrics as M
from repro_torch.obs import scorecard as S
from repro_torch.sparse import DeltaGateConfig, QuantConfig, lstm_policy
from repro_torch.traffic import RequestRecord, summarize

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_hw_is_the_h100():
    """The H100 SXM's published rates under the reference's names; the
    launch plans and chip_smoke's bounds read them."""
    from repro_torch.kernels import plan
    assert (hw.HBM_BW, hw.PEAK_BF16_FLOPS, hw.PEAK_INT8_OPS,
            hw.PEAK_FP32_FLOPS) == (3.35e12, 989e12, 1979e12, 67e12)
    assert hw.HBM_PER_CHIP == 80 * 10**9
    assert hw.SMEM_PER_BLOCK == plan.SMEM_PER_BLOCK == 232448
    assert hw.SMS == plan.SMS == 132
    for name in ("MXU_TILE", "LANE", "SUBLANE", "ICI_BW", "VMEM_BYTES"):
        assert not hasattr(hw, name)
    src = (ROOT / "chip_smoke.py").read_text()
    assert "HBM_BYTES_PER_S = hw.HBM_BW" in src and "3.35e12" not in src


# ---------------------------------------------------------------- metrics

def _observe(mod, record, summ):
    recs = [record(0, scheduled=0.0, first_token=0.5, finished=1.0,
                   tokens=6, reason="done"),
            record(1, scheduled=0.0, first_token=0.002, finished=0.0051,
                   tokens=3, reason="done"),
            record(2, scheduled=0.0, tokens=0, reason="rejected"),
            record(3, scheduled=0.0, first_token=7.5, finished=7.5,
                   tokens=1, reason="expired")]
    reg = mod.MetricsRegistry()
    reg.absorb_traffic(recs, summ(recs, wall=2.0, offered_rps=4.0))
    reg.absorb_spec({"rounds": 3, "drafted": 9, "accepted": 6,
                     "acceptance_rate": 2 / 3})
    reg.absorb_counters({"tokens": 6.0, "fired_x_l0": 11.5})
    reg.counter("req_total", "requests").inc(3)
    reg.gauge("depth").set(2.5)
    h = reg.histogram("lat_ms", "latency", buckets=(1, 10))
    for v in (0.5, 5.0, 50.0, float("nan")):
        h.observe(v)
    return reg


def test_metrics_exports_are_the_references(tmp_path):
    """The same observations (traffic records, spec stats, device counters,
    a counter, a gauge, a histogram with a NaN) give the reference's
    Prometheus text and JSON, byte for byte on disk."""
    reg = _observe(M, RequestRecord, summarize)
    jreg = _observe(JM, JRecord, j_summarize)
    assert reg.to_prometheus() == jreg.to_prometheus()
    assert reg.to_json() == jreg.to_json()
    for name in ("m.prom", "m.json"):
        reg.dump(str(tmp_path / f"t_{name}"))
        jreg.dump(str(tmp_path / f"j_{name}"))
        assert (tmp_path / f"t_{name}").read_bytes() == \
            (tmp_path / f"j_{name}").read_bytes()
    with pytest.raises(ValueError):
        reg.counter("req_total").inc(-1)
    with pytest.raises(TypeError):
        reg.gauge("req_total")
    from repro_torch.obs import MetricsRegistry
    assert MetricsRegistry is M.MetricsRegistry


# -------------------------------------------------------------- scorecard

@pytest.fixture(scope="module")
def ptb():
    """lstm_ptb at its published width (X = H = 1500, V = 10000), seed-0
    reference weights in both packages."""
    jm = JLSTMModel(J_LSTM_CONFIGS["lstm_ptb"])
    jp = jm.init(jax.random.key(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _to_reference(tree):
    """The port's packed tree as the reference's: the same arrays in its
    ``RowBalancedSparse`` / ``RowBalancedSparseQ8`` leaves."""
    import dataclasses
    from repro.core.packing import RowBalancedSparse as JRBS
    from repro.quant.formats import RowBalancedSparseQ8 as JQ8
    from repro_torch.core.packing import RowBalancedSparse
    from repro_torch.quant.formats import RowBalancedSparseQ8
    if isinstance(tree, dict):
        return {k: _to_reference(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_reference(v) for v in tree]
    cls = {RowBalancedSparse: JRBS, RowBalancedSparseQ8: JQ8}.get(type(tree))
    if cls is not None:
        return cls(**{f.name: _to_reference(getattr(tree, f.name))
                      for f in dataclasses.fields(tree)})
    if isinstance(tree, torch.Tensor):
        return jax.numpy.asarray(tree.numpy())
    return tree


@pytest.mark.parametrize("kind", ["dense", "packed", "q8"])
def test_scorecard_ledger_matches_reference(ptb, kind):
    """``layer_geometry`` and ``weight_stream_bytes`` equal the
    reference's on the same tree (dense, or packed by ``lstm_policy(0.75,
    0.5)`` to floats or int8 codes and handed to the reference in its own
    leaf types); ``build`` gives the reference's card
    but for the fields that read ``hw``, which are the H100's: the bound
    batch · 3.35 TB/s / weight-stream bytes, its effective GOPS and the
    gap. ``render`` names the card."""
    jp, p = ptb
    if kind != "dense":
        plan = lstm_policy(0.75, 0.5, quant=QuantConfig("int8")
                           if kind == "q8" else None,
                           delta=DeltaGateConfig(0.0, 0.0)).compile(p)
        p = plan.pack(*plan.prune(p))[0]
        jp = _to_reference(p)
    geo = S.layer_geometry(p)
    assert geo == JS.layer_geometry(jp)
    nbytes = S.weight_stream_bytes(p)
    assert nbytes == JS.weight_stream_bytes(jp)
    counters = {"tokens": 512.0, "decode_steps": 64.0, "spec_drafted": 40.0,
                "spec_accepted": 29.0, "fired_x_l0": 300000.0,
                "fired_h_l0": 450000.0}
    if kind == "dense":
        counters = {k: v for k, v in counters.items()
                    if not k.startswith("fired")}
    card = S.build(p, counters, 0.75, batch=8, step_sum=8 * 96.0)
    want = JS.build(jp, counters, 0.75, batch=8, step_sum=8 * 96.0)
    hw_fields = ("bound_toks_per_s", "bound_effective_gops", "roofline_gap")
    assert {k: v for k, v in card.items() if k not in hw_fields} == \
        {k: v for k, v in want.items() if k not in hw_fields}
    bound = 8 * hw.HBM_BW / nbytes
    assert card["bound_toks_per_s"] == round(bound, 1)
    assert card["bound_effective_gops"] == round(
        2.0 * geo[0]["dense_macs"] * bound / 1e9, 3)
    assert card["roofline_gap"] == round(bound / (512 / 0.75), 2)
    assert ("occupancy_x" in card) == (kind != "dense")
    text = S.render(card, "NVIDIA H100 80GB HBM3")
    assert text.startswith("scorecard on NVIDIA H100 80GB HBM3:")
    assert "3.35 TB/s (NVIDIA H100 SXM)" in text
    assert "effective GOPS" in text and "spec acceptance 72.5%" in text


# --------------------------------------------------------------- roofline

def test_roofline_analytic_functions_match_reference():
    """``model_flops`` (MoE: the active-expert model; the
    encoder-decoder: its encoder and decoder layers) and
    ``analytic_hbm_bytes`` (optimizer bytes on and off, 1 and 4 chips)
    equal the reference's for every arch of the zoo at full width, over
    every shape."""
    checked = set()
    for name in ARCH_NAMES:
        arch, jarch = get_arch(name), j_get_arch(name)
        for key, shape in SHAPES.items():
            jshape = J_SHAPES[key]
            assert roofline.model_flops(arch, shape) == \
                j_roofline.model_flops(jarch, jshape)
            for chips in (1, 4):
                for opt in (True, False):
                    assert roofline.analytic_hbm_bytes(
                        arch, shape, chips, opt) == \
                        j_roofline.analytic_hbm_bytes(jarch, jshape, chips,
                                                      opt)
        checked.add(name)
    assert checked == set(ARCH_NAMES) and len(checked) == 10


# ---------------------------------------------------------------- serving

def test_serving_exports_cover_the_references():
    """``repro_torch.serving`` exports every public name of the
    reference's ``repro.serving`` (``cache_shardings`` since sharded
    serving); ``Request`` has the reference's fields and every model the
    port builds conforms to ``DecodeStep``."""
    import dataclasses
    from repro_torch.models import LSTMModel
    from repro_torch.serving import (ContinuousBatchingEngine, DecodeStep,
                                     Finished, Request, TokenEvent)
    assert set(j_serving.__all__) <= set(serving.__all__)
    assert all(hasattr(serving, n) for n in serving.__all__)
    assert [f.name for f in dataclasses.fields(Request)] == \
        [f.name for f in dataclasses.fields(j_serving.Request)]
    assert isinstance(LSTMModel(LSTM_CONFIGS["lstm_ptb"]), DecodeStep)
    assert isinstance(build_model(get_arch("rwkv6-7b")), DecodeStep)
    assert not serving.conforms(object())
    assert ContinuousBatchingEngine and Finished and TokenEvent


# -------------------------------------------------------------------- CLI

def test_serve_cli_metrics_and_scorecard(capsys, tmp_path):
    """``--metrics`` on rwkv6-7b's smoke config (JSON) and on the hybrid's
    scheduler (Prometheus text); ``--scorecard`` on a packed LSTM prints
    the card against the H100's bound; both on a zoo model errors out."""
    from repro_torch.launch import serve
    f = tmp_path / "m.json"
    serve.main(["--arch", "rwkv6-7b", "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt-len", "20", "--gen", "4",
                "--metrics", str(f)])
    js = json.loads(f.read_text())
    assert js["dev_tokens"]["value"] == 8.0
    assert js["dev_decode_steps"]["value"] == 4.0
    assert js["serve_toks_per_s"]["value"] > 0
    prom = tmp_path / "m.prom"
    serve.main(["--arch", "recurrentgemma-9b", "--smoke", "--device", "cpu",
                "--continuous", "--slots", "2", "--batch", "3",
                "--prompt-len", "36", "--gen", "4", "--metrics", str(prom)])
    text = prom.read_text()
    assert "# TYPE dev_tokens gauge" in text and "dev_tokens 12" in text
    capsys.readouterr()
    serve.main(["--arch", "lstm_ptb", "--smoke", "--brds", "--device", "cpu",
                "--batch", "2", "--prompt-len", "4", "--gen", "3",
                "--scorecard"])
    out = capsys.readouterr().out
    assert "scorecard on cpu:" in out and "effective GOPS" in out
    assert "at 3.35 TB/s (NVIDIA H100 SXM)" in out
    assert "tokens 6 in" in out
    with pytest.raises(SystemExit):
        serve.main(["--arch", "recurrentgemma-9b", "--smoke", "--device",
                    "cpu", "--scorecard"])
    assert "LSTM-only" in capsys.readouterr().err


def test_port_imports_neither_jax_nor_the_reference():
    """No file of the port, and not chip_smoke.py, imports JAX or the
    reference package (``repro``), at any indentation."""
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                     re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    assert len(files) > 80
    found = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
             for p in files + [ROOT / "chip_smoke.py"]
             for m in bad.finditer(p.read_text())]
    assert not found, found

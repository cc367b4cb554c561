"""The port's kernel layer on the CPU: its plain versions against the JAX
reference's kernels (``backend="pallas"``, interpret mode on the CPU) and
plain versions (``backend="ref"``) on the very packing the reference made,
fused vs chained bitwise inside the port, backend resolution, and the
package's import isolation. The CUDA kernels themselves run only on the
card (``chip_smoke.py``)."""
import ast
import importlib
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.packing import pack_from_dense, pad_packed
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.kernels import delta_rb_spmv as tdelta
from repro_torch.kernels import fused_step as tfused
from repro_torch.kernels import rb_spmv as trb
from repro_torch.kernels import rb_spmv_q8 as tq8
from repro_torch.models import packed_from_numpy
from repro_torch.sparse import backend as tbackend

# the package re-exports the ``lstm_gates`` op under the module's name
tgates = importlib.import_module("repro_torch.kernels.lstm_gates")

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-5   # float32: the two frameworks sum and round in other orders


def _arr(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _case(seed, B, X, H, spar_x=0.75, spar_h=0.5, pad=True):
    """Reference-packed Sx/Sh plus activations, in both frameworks."""
    rng = np.random.default_rng(seed)
    sx = pack_from_dense(jnp.asarray(_arr(rng, 4 * H, X, scale=X ** -0.5)),
                         spar_x)
    sh = pack_from_dense(jnp.asarray(_arr(rng, 4 * H, H, scale=H ** -0.5)),
                         spar_h)
    if pad:
        sx, sh = pad_packed(sx), pad_packed(sh)
    arrs = dict(x=_arr(rng, B, X), h=_arr(rng, B, H), c=_arr(rng, B, H),
                b=_arr(rng, 4 * H, scale=0.1))
    j = dict(sx=sx, sh=sh, **{k: jnp.asarray(v) for k, v in arrs.items()})
    t = dict(sx=packed_from_numpy(sx.values, sx.deltas, sx.ncols, sx.pad,
                                  sx.block_rows),
             sh=packed_from_numpy(sh.values, sh.deltas, sh.ncols, sh.pad,
                                  sh.block_rows),
             **{k: torch.from_numpy(v) for k, v in arrs.items()})
    return j, t


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


def test_pwl_tables_identical():
    want, got = jref.pwl_tables(), ref.pwl_tables()
    for key in ("sig", "tanh"):
        for a, b in zip(want[key], got[key]):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype == np.float32
    assert tgates._HIC == float(np.float32(want["hi"] - 1e-6))


def test_pwl_activations_match():
    """The LUT activations, including the segment edges, the hi - 1e-6
    clip and saturation outside [-8, 8)."""
    x = np.concatenate([np.linspace(-10, 10, 2001),
                        np.arange(-8, 9, dtype=np.float64),
                        [7.999999, 7.9999995, -8.000001, 8.000001]])
    x = x.astype(np.float32)
    for jf, tf in ((jref.pwl_sigmoid_ref, ref.pwl_sigmoid_ref),
                   (jref.pwl_tanh_ref, ref.pwl_tanh_ref)):
        _close(tf(torch.from_numpy(x)), jf(jnp.asarray(x)), atol=1e-6)


@pytest.mark.parametrize("jbackend", ["pallas", "ref"])
@pytest.mark.parametrize("B,X,H,pad", [(3, 100, 96, True), (2, 48, 64, False),
                                       (1, 200, 40, True)])
def test_rb_dual_spmv_matches_jax(jbackend, B, X, H, pad):
    j, t = _case(0, B, X, H, pad=pad)
    want = jops.rb_dual_spmv(j["sx"], j["x"], j["sh"], j["h"], j["b"],
                             backend=jbackend)
    got = ops.rb_dual_spmv(t["sx"], t["x"], t["sh"], t["h"], t["b"])
    assert got.shape == (B, 4 * H)
    _close(got, want)


@pytest.mark.parametrize("jbackend", ["pallas", "ref"])
@pytest.mark.parametrize("B,X,H,pad", [(3, 100, 96, True), (2, 48, 64, False),
                                       (1, 200, 40, True)])
def test_rb_spmv_matches_jax(jbackend, B, X, H, pad):
    """The single-family SpMV on both families, padded struct or not:
    only the logical rows come out."""
    j, t = _case(5, B, X, H, pad=pad)
    for fam, act in (("sx", "x"), ("sh", "h")):
        want = jops.rb_spmv(j[fam], j[act], backend=jbackend)
        got = ops.rb_spmv(t[fam], t[act])
        assert got.shape == (B, 4 * H) and got.dtype == torch.float32
        _close(got, want)


def test_single_family_sum_equals_dual():
    """rb_spmv(Sx, x) + rb_spmv(Sh, h) + bias is rb_dual_spmv bit for bit:
    the same products, summed per family, added in the same order."""
    _, t = _case(6, 3, 72, 40)
    z = (ops.rb_spmv(t["sx"], t["x"]) + ops.rb_spmv(t["sh"], t["h"])
         + t["b"][None, :])
    assert torch.equal(z, ops.rb_dual_spmv(t["sx"], t["x"], t["sh"], t["h"],
                                           t["b"]))


@pytest.mark.parametrize("jbackend", ["pallas", "ref"])
@pytest.mark.parametrize("pwl", [False, True])
@pytest.mark.parametrize("B,H", [(3, 96), (2, 128)])
def test_lstm_gates_matches_jax(jbackend, pwl, B, H):
    rng = np.random.default_rng(1)
    zs = [_arr(rng, B, H, scale=4.0) for _ in range(4)]
    c = _arr(rng, B, H)
    want = jops.lstm_gates(*map(jnp.asarray, zs), jnp.asarray(c), pwl=pwl,
                           backend=jbackend)
    got = ops.lstm_gates(*map(torch.from_numpy, zs), torch.from_numpy(c),
                         pwl=pwl)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("jbackend", ["pallas", "ref"])
@pytest.mark.parametrize("pwl", [False, True])
@pytest.mark.parametrize("B,X,H", [(3, 100, 96), (2, 64, 128)])
def test_fused_step_matches_jax(jbackend, pwl, B, X, H):
    j, t = _case(2, B, X, H)
    want = jops.fused_brds_lstm_step(j["sx"], j["x"], j["sh"], j["h"],
                                     j["b"], j["c"], pwl=pwl,
                                     backend=jbackend)
    got = ops.fused_brds_lstm_step(t["sx"], t["x"], t["sh"], t["h"], t["b"],
                                   t["c"], pwl=pwl)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("pwl", [False, True])
@pytest.mark.parametrize("pad", [False, True])
def test_fused_bitwise_vs_chained(pwl, pad):
    """Inside the port the fused step equals the chained pair bit for bit,
    pre-padded struct or not."""
    _, t = _case(3, 3, 72, 40, pad=pad)
    args = (t["sx"], t["x"], t["sh"], t["h"], t["b"], t["c"])
    cf, hf = ops.fused_brds_lstm_step(*args, pwl=pwl)
    cc, hc = ops.brds_lstm_step(*args, pwl=pwl)
    assert torch.equal(cf, cc) and torch.equal(hf, hc)


def test_backend_resolution():
    cpu = torch.zeros(1)
    assert tbackend.resolve(None, cpu) == "ref"
    assert tbackend.resolve("auto", cpu) == "ref"
    assert tbackend.resolve("ref", cpu) == "ref"
    with pytest.raises(ValueError):
        tbackend.resolve("cuda", cpu)
    with pytest.raises(ValueError):
        tbackend.resolve("pallas", cpu)
    with tbackend.use_backend("cuda"):
        assert tbackend.get_default_backend() == "cuda"
        with pytest.raises(ValueError):
            tbackend.resolve(None, cpu)
    assert tbackend.get_default_backend() == "auto"


def test_cpu_tensors_never_reach_a_kernel():
    """On CPU tensors the plain versions run and no launch is counted;
    backend "cuda" and the kernel wrappers refuse them before any build."""
    _, t = _case(4, 2, 32, 16)
    before = dict(ops.LAUNCHES)
    args = (t["sx"], t["x"], t["sh"], t["h"], t["b"], t["c"])
    ops.fused_brds_lstm_step(*args)
    ops.brds_lstm_step(*args)
    assert ops.LAUNCHES == before
    with pytest.raises(ValueError):
        ops.fused_brds_lstm_step(*args, backend="cuda")
    sx, sh = t["sx"], t["sh"]
    with pytest.raises(ValueError, match="CUDA"):
        trb.rb_dual_spmv(sx.values, sx.deltas, t["x"], sh.values, sh.deltas,
                         t["h"], t["b"])
    with pytest.raises(ValueError, match="CUDA"):
        tfused.fused_brds_lstm_step(sx.values, sx.deltas, t["x"], sh.values,
                                    sh.deltas, t["h"], t["b"], t["c"])
    z = torch.zeros((2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        tgates.lstm_gates(z[:, :16], z[:, 16:32], z[:, 32:48], z[:, 48:],
                          t["c"])
    # the temporal-delta and q8 paths: plain versions on CPU tensors, and
    # their kernel wrappers refuse them
    fx, fh = (t["x"] > 0).float(), (t["h"] > 0).float()
    m = torch.zeros((2, 64))
    ops.fused_brds_delta_lstm_step(sx, t["x"], fx, sh, t["h"], fh, m,
                                   t["b"], t["c"])
    ops.brds_delta_lstm_step(sx, t["x"], fx, sh, t["h"], fh, m, t["b"],
                             t["c"])
    with pytest.raises(ValueError, match="CUDA"):
        tdelta.delta_rb_dual_spmv(sx.values, sx.deltas, t["x"], fx,
                                  sh.values, sh.deltas, t["h"], fh, m)
    with pytest.raises(ValueError, match="CUDA"):
        tfused.fused_brds_delta_lstm_step(sx.values, sx.deltas, t["x"], fx,
                                          sh.values, sh.deltas, t["h"], fh,
                                          m, t["b"], t["c"])
    from repro_torch.quant import quantize_packed
    qx8, qh8 = quantize_packed(sx, "int8"), quantize_packed(sh, "int8")
    ops.fused_brds_lstm_step_q8(qx8, t["x"], qh8, t["h"], t["b"], t["c"])
    ops.brds_lstm_step_q8(qx8, t["x"], qh8, t["h"], t["b"], t["c"])
    ops.brds_delta_lstm_step_q8(qx8, t["x"], fx, qh8, t["h"], fh, m, t["b"],
                                t["c"])
    codes = torch.zeros((2, 32), dtype=torch.int8)
    comb = torch.ones(64)
    with pytest.raises(ValueError, match="CUDA"):
        tq8.rb_dual_parts_q8(qx8.values, qx8.deltas, comb, codes, qh8.values,
                             qh8.deltas, comb, codes[:, :16], 64)
    with pytest.raises(ValueError, match="CUDA"):
        tfused.fused_brds_lstm_step_q8(qx8.values, qx8.deltas, comb, codes,
                                       qh8.values, qh8.deltas, comb,
                                       codes[:, :16], t["b"], t["c"])
    # the fused delta-q8 step and the single-family kernels
    ops.fused_brds_delta_lstm_step_q8(qx8, t["x"], fx, qh8, t["h"], fh, m,
                                      t["b"], t["c"])
    ops.rb_spmv(sx, t["x"])
    ops.rb_spmv_q8(qx8, t["x"])
    ops.delta_rb_spmv(sx, t["x"], fx.bool())
    with pytest.raises(ValueError):
        ops.rb_spmv(sx, t["x"], backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tfused.fused_brds_delta_lstm_step_q8(
            qx8.values, qx8.deltas, comb, codes, qh8.values, qh8.deltas,
            comb, codes[:, :16], m, t["b"], t["c"])
    with pytest.raises(ValueError, match="CUDA"):
        trb.rb_spmv(sx.values, sx.deltas, t["x"], 64)
    with pytest.raises(ValueError, match="CUDA"):
        tq8.rb_spmv_q8(qx8.values, qx8.deltas, comb, codes, 64)
    with pytest.raises(ValueError, match="CUDA"):
        tdelta.delta_rb_spmv(sx.values, sx.deltas, t["x"], fx, 64)
    assert ops.LAUNCHES == before


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT))
    for p in [*(ROOT / "src" / "repro_torch").rglob("*.py"),
              ROOT / "chip_smoke.py"]))
def test_port_imports_no_jax_or_reference(path):
    bad = [m for m in _imports(ROOT / path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


def test_import_needs_no_compiler_and_loads_no_jax():
    """Importing every port module starts no build, and pulls in neither
    JAX nor the reference package."""
    code = ("import sys, repro_torch, repro_torch.launch.serve, "
            "repro_torch.serving, repro_torch.kernels.ops as o, "
            "repro_torch.quant, repro_torch.sparse.temporal, "
            "repro_torch.kernels._build as b\n"
            "assert not b._libs and not b.BUILD_LOG\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "PATH": "/usr/bin:/bin"}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


@pytest.mark.parametrize("B", [1, 16, 17, 64, 1000])
def test_kernel_wrappers_take_any_batch_of_at_least_one_row(B):
    """The row-balanced kernels run a batch above 16 rows in 16-row tiles
    inside one launch (the scans one launch a tile), so the wrappers'
    batch check accepts any B >= 1; the plain route serves the same B."""
    from repro_torch.core import pack_from_dense as tpack
    from repro_torch.kernels.rb_spmv import check_batch
    check_batch(B)
    rng = np.random.default_rng(B)
    s = tpack(torch.from_numpy(rng.normal(size=(32, 24)).astype(np.float32)),
              0.5)
    x = torch.from_numpy(rng.normal(size=(B, 24)).astype(np.float32))
    y = ops.rb_spmv(s, x)
    assert y.shape == (B, 32)
    assert torch.equal(y[-1:], ops.rb_spmv(s, x[-1:]))


@pytest.mark.parametrize("B", [0, -1])
def test_kernel_wrappers_refuse_an_empty_batch(B):
    from repro_torch.kernels.rb_spmv import check_batch
    with pytest.raises(ValueError, match="at least one row"):
        check_batch(B)


class _FakeLib:
    """Stands in for a built library: records each entry point's
    arguments, returns cudaSuccess."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *a: self.calls.append((name, a)) or 0


def _as_if_on_a_card(monkeypatch, lib):
    """The wrappers' device checks pass CPU tensors, the card has 132 SMs,
    and the build is ``lib``: what a wrapper checks and hands the launch
    shows without a card."""
    real = tq8._build.require
    monkeypatch.setattr(tq8._build, "require",
                        lambda t, name, **kw: real(_CudaLike(t), name, **kw))
    monkeypatch.setattr(tq8._build, "sm_count", lambda device: 132)
    monkeypatch.setattr(tq8._build, "stream", lambda device: 0)
    monkeypatch.setattr(tq8._build, "load", lambda name: lib)
    monkeypatch.setattr(tq8._build, "LAUNCHES", dict(tq8._build.LAUNCHES))


class _CudaLike:
    """A CPU tensor that reports itself as a CUDA one to the checks."""

    def __init__(self, t):
        self._t = t

    is_cuda = True

    def __getattr__(self, name):
        return getattr(self._t, name)


@pytest.mark.parametrize("which", ["codes", "deltas"])
def test_misaligned_rb_spmv_q8_operand_raises_before_a_launch(
        monkeypatch, which):
    """B10 loads four codes and four deltas at once: its wrapper refuses
    packed arrays that do not start on 16 bytes before it builds or
    launches anything, and launches the aligned ones on the single-family
    q8 plan."""
    lib = _FakeLib()
    _as_if_on_a_card(monkeypatch, lib)
    R, K, X, B = 64, 12, 48, 3
    codes = torch.zeros(R * K + 16, dtype=torch.int8)
    deltas = torch.ones(R * K + 16, dtype=torch.int16)
    arrays = {"codes": codes[:R * K].view(R, K),
              "deltas": deltas[:R * K].view(R, K)}
    comb = torch.ones(R)
    q = torch.zeros(B, X, dtype=torch.int8)
    tq8.rb_spmv_q8(arrays["codes"], arrays["deltas"], comb, q, R)
    (name, args), = lib.calls
    plan = tq8.single_q8_plan_for(arrays["codes"], q, R)
    assert name == "brds_rb_spmv_q8" and plan.families == 1
    assert args[11:17] == (plan.rows, 1, plan.shift_x, plan.slot_bits,
                           plan.xpad, plan.smem)
    flat = {"codes": codes, "deltas": deltas}[which]
    arrays[which] = flat[1:R * K + 1].view(R, K)
    with pytest.raises(ValueError, match="16-byte"):
        tq8.rb_spmv_q8(arrays["codes"], arrays["deltas"], comb, q, R)
    assert len(lib.calls) == 1


@pytest.mark.parametrize("pdl", [True, False])
def test_lstm_gates_launch_arguments(monkeypatch, pdl):
    """B2's wrapper hands the launch z's row stride, the cell plan's grid
    (one unit a thread, at most one wave) and the programmatic launch
    unless asked for a plain one."""
    lib = _FakeLib()
    _as_if_on_a_card(monkeypatch, lib)
    B, H = 8, 1500
    z, c = torch.zeros(B, 4 * H), torch.zeros(B, H)
    tgates.lstm_gates(*(z[:, i * H:(i + 1) * H] for i in range(4)), c,
                      pdl=pdl)
    (name, args), = lib.calls
    assert name == "brds_lstm_gates"
    assert args[4] == 4 * H and args[8:12] == (B, H, 94, int(pdl))

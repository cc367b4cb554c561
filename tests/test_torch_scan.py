"""The port's multi-token scans on the CPU: the plain versions of
``ops.fused_brds_lstm_scan`` and ``ops.fused_brds_delta_lstm_scan``
against the JAX reference's scans (``backend="pallas"``, interpret mode on
the CPU, and ``backend="ref"``) on the very packing the reference made,
each bitwise equal to T of the port's own single steps, and the CUDA
wrappers refusing CPU tensors. The CUDA kernels themselves run only on the
card (``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.packing import pack_from_dense, pad_packed
from repro.kernels import ops as jops
from repro_torch.kernels import fused_scan as tscan
from repro_torch.kernels import ops
from repro_torch.models import packed_from_numpy
from repro_torch.sparse.temporal import delta_threshold

# float32 sums in another order than the reference's, carried through T
# recurrent steps
ATOL = 1e-6
# the delta scan's partial-sum memory m is a running float32 sum of
# magnitude up to 5 here, each step's products added in another order:
# a few ulps at that magnitude, which the cell and h_ref read
DELTA_ATOL = 5e-6
T = 6
SHAPES = [(3, 100, 96, True), (2, 48, 64, False), (3, 40, 33, True)]


def _arr(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _case(seed, B, X, H, pad):
    """Reference-packed Sx/Sh, a (T, B, X) input sequence and initial
    states, in both frameworks."""
    rng = np.random.default_rng(seed)
    sx = pack_from_dense(jnp.asarray(_arr(rng, 4 * H, X, scale=X ** -0.5)),
                         0.75)
    sh = pack_from_dense(jnp.asarray(_arr(rng, 4 * H, H, scale=H ** -0.5)),
                         0.5)
    if pad:
        sx, sh = pad_packed(sx), pad_packed(sh)
    arrs = dict(xs=_arr(rng, T, B, X), h=_arr(rng, B, H), c=_arr(rng, B, H),
                b=_arr(rng, 4 * H, scale=0.1), xr=_arr(rng, B, X, scale=0.5),
                hr=_arr(rng, B, H, scale=0.5), m=_arr(rng, B, 4 * H))
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


@pytest.mark.parametrize("jbackend", ["pallas", "ref"])
@pytest.mark.parametrize("pwl", [False, True])
@pytest.mark.parametrize("B,X,H,pad", SHAPES)
def test_scan_matches_jax(jbackend, pwl, B, X, H, pad):
    j, t = _case(11, B, X, H, pad)
    want = jops.fused_brds_lstm_scan(j["sx"], j["xs"], j["sh"], j["h"],
                                     j["b"], j["c"], pwl=pwl,
                                     backend=jbackend)
    got = ops.fused_brds_lstm_scan(t["sx"], t["xs"], t["sh"], t["h"], t["b"],
                                   t["c"], pwl=pwl)
    assert got[0].shape == (T, B, H) and got[1].shape == (B, H)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("jbackend", ["pallas", "ref"])
@pytest.mark.parametrize("theta", [0.0, 0.05])
@pytest.mark.parametrize("pwl", [False, True])
@pytest.mark.parametrize("B,X,H,pad", SHAPES[:2])
def test_delta_scan_matches_jax(jbackend, theta, pwl, B, X, H, pad):
    j, t = _case(12, B, X, H, pad)
    want = jops.fused_brds_delta_lstm_scan(
        j["sx"], j["xs"], j["sh"], j["h"], j["c"], j["xr"], j["hr"], j["m"],
        j["b"], theta_x=theta, theta_h=theta, pwl=pwl, backend=jbackend)
    got = ops.fused_brds_delta_lstm_scan(
        t["sx"], t["xs"], t["sh"], t["h"], t["c"], t["xr"], t["hr"], t["m"],
        t["b"], theta_x=theta, theta_h=theta, pwl=pwl)
    for g, w in zip(got, want):        # hs, c, x_ref, h_ref, m
        assert g.shape == tuple(w.shape)
        _close(g, w, DELTA_ATOL)


def _steps(t, pwl):
    c, h, hs = t["c"], t["h"], []
    for x in t["xs"]:
        c, h = ops.fused_brds_lstm_step(t["sx"], x, t["sh"], h, t["b"], c,
                                        pwl=pwl)
        hs.append(h)
    return torch.stack(hs), c


def _delta_steps(t, theta, pwl):
    c, h, xr, hr, m, hs = t["c"], t["h"], t["xr"], t["hr"], t["m"], []
    for x in t["xs"]:
        dx, fx, xr = delta_threshold(x, xr, theta)
        dh, fh, hr = delta_threshold(h, hr, theta)
        c, h, m = ops.fused_brds_delta_lstm_step(t["sx"], dx, fx, t["sh"], dh,
                                                 fh, m, t["b"], c, pwl=pwl)
        hs.append(h)
    return torch.stack(hs), c, xr, hr, m


@pytest.mark.parametrize("kind", ["float", "delta0", "delta0.05"])
@pytest.mark.parametrize("pwl", [False, True])
def test_scan_bitwise_equal_to_steps(kind, pwl):
    """The plain scans are T of the port's own plain steps (the delta one
    after the thresholds), bit for bit: the contract the kernels are held
    to on the card."""
    _, t = _case(13, 3, 100, 96, True)
    if kind == "float":
        got = ops.fused_brds_lstm_scan(t["sx"], t["xs"], t["sh"], t["h"],
                                       t["b"], t["c"], pwl=pwl)
        want = _steps(t, pwl)
    else:
        theta = float(kind[5:])
        got = ops.fused_brds_delta_lstm_scan(
            t["sx"], t["xs"], t["sh"], t["h"], t["c"], t["xr"], t["hr"],
            t["m"], t["b"], theta_x=theta, theta_h=theta, pwl=pwl)
        want = _delta_steps(t, theta, pwl)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_delta_scan_at_theta_zero_tracks_every_input():
    """At Θ=0 the references end as the last inputs, bit for bit."""
    _, t = _case(14, 2, 48, 64, False)
    hs, _, xr, hr, _ = ops.fused_brds_delta_lstm_scan(
        t["sx"], t["xs"], t["sh"], t["h"], t["c"], t["xr"], t["hr"], t["m"],
        t["b"], theta_x=0.0, theta_h=0.0)
    assert torch.equal(xr, t["xs"][-1]) and torch.equal(hr, hs[-2])


def test_scan_cpu_tensors_never_reach_a_kernel():
    """On CPU tensors the plain scans run and no launch is counted; backend
    "cuda" and the kernel wrappers refuse them before any build."""
    _, t = _case(15, 2, 48, 64, True)
    before = dict(ops.LAUNCHES)
    ops.fused_brds_lstm_scan(t["sx"], t["xs"], t["sh"], t["h"], t["b"],
                             t["c"])
    ops.fused_brds_delta_lstm_scan(t["sx"], t["xs"], t["sh"], t["h"], t["c"],
                                   t["xr"], t["hr"], t["m"], t["b"],
                                   theta_x=0.0, theta_h=0.0)
    assert ops.LAUNCHES == before
    assert {"fused_brds_lstm_scan", "fused_brds_delta_lstm_scan"} <= set(
        ops.LAUNCHES)
    with pytest.raises(ValueError):
        ops.fused_brds_lstm_scan(t["sx"], t["xs"], t["sh"], t["h"], t["b"],
                                 t["c"], backend="cuda")
    sx, sh = t["sx"], t["sh"]
    with pytest.raises(ValueError, match="CUDA"):
        tscan.fused_brds_lstm_scan(sx.values, sx.deltas, t["xs"], sh.values,
                                   sh.deltas, t["h"], t["b"], t["c"])
    with pytest.raises(ValueError, match="CUDA"):
        tscan.fused_brds_delta_lstm_scan(
            sx.values, sx.deltas, t["xs"], sh.values, sh.deltas, t["h"],
            t["c"], t["xr"], t["hr"], t["m"], t["b"], theta_x=0.0,
            theta_h=0.0)


@pytest.mark.parametrize("kind", ["float", "delta0.05"])
def test_scan_batch_tiles_concatenate_to_the_whole_batch(kind):
    """A batch above the 16 rows a scan launch takes runs as one call per
    16-row tile (``fused_scan.batch_tiles``); with the plain scan standing
    in for the kernel, the tiles' outputs concatenated are bitwise the
    whole batch's, and a batch of at most 16 rows is one uncut call."""
    _, t = _case(16, 40, 48, 33, True)
    calls = []
    if kind == "float":
        def scan(xs, h, c):
            calls.append(xs.shape[1])
            return ops.fused_brds_lstm_scan(t["sx"], xs, t["sh"], h, t["b"],
                                            c)
        args, ins, outs = (t["xs"], t["h"], t["c"]), (1, 0, 0), (1, 0)
    else:
        def scan(xs, h, c, xr, hr, m):
            calls.append(xs.shape[1])
            return ops.fused_brds_delta_lstm_scan(
                t["sx"], xs, t["sh"], h, c, xr, hr, m, t["b"],
                theta_x=0.05, theta_h=0.05)
        args = (t["xs"], t["h"], t["c"], t["xr"], t["hr"], t["m"])
        ins, outs = (1, 0, 0, 0, 0, 0), (1, 0, 0, 0, 0)
    got = tscan.batch_tiles(scan, 40, args, ins, outs)
    assert calls == [16, 16, 8]
    whole = scan(*args)
    assert len(got) == len(whole)
    for g, w in zip(got, whole):
        assert torch.equal(g, w)
    calls.clear()
    small = tuple(a.narrow(d, 0, 16) for a, d in zip(args, ins))
    tscan.batch_tiles(scan, 16, small, ins, outs)
    assert calls == [16]

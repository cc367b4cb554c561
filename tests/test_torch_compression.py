"""int8 gradient compression with error feedback
(``repro_torch.training.compression``) against the JAX reference's
``repro/training/compression.py``.

``quantize`` / ``dequantize`` on one process; ``compressed_psum`` and
``tree_compressed_psum`` on 4 gloo CPU ranks (over a mesh's ``data`` axis
and over the default process group), three steps of error feedback, held
to the reference's ``compressed_psum`` under ``jax.vmap(...,
axis_name="data")`` over the same 4 shards: the means and the residuals
bitwise (the int32 totals are exact, so the means are too); ``wire_bytes``
for int8 and float32. The ranks start once; their function imports no
JAX.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import compression as J
from repro_torch.launch.mesh import run_ranks
from repro_torch.training import compression as C

N = 4                      # ranks
STEPS = 3                  # error-feedback steps
SHAPES = {"a": (37, 5), "b": (100,), "c": (3, 4, 6)}


def _grads(step: int) -> dict:
    """Per-rank gradient shards (N, *shape), float32, of mixed scales (a
    leaf whose max lies on one rank, one all zero at step 0)."""
    rng = np.random.default_rng(10 + step)
    out = {}
    for i, (k, sh) in enumerate(SHAPES.items()):
        g = rng.standard_normal((N,) + sh).astype(np.float32)
        g *= np.float32(10.0 ** (i - 1))
        if k == "b":
            g[2, 7] = np.float32(40.0)
        if k == "c" and step == 0:
            g[:] = 0
        out[k] = g
    return out


def _rank(mesh):
    """Three error-feedback steps of ``tree_compressed_psum`` over the
    mesh's ``data`` axis, one leaf's ``compressed_psum`` over the default
    group, and an int32 total of large codes."""
    import torch.distributed as dist
    from repro_torch.dist.collective_ops import all_reduce
    from repro_torch.training import compression as C
    r = dist.get_rank()
    res = None
    steps = []
    for s in range(STEPS):
        g = {k: torch.from_numpy(v[r].copy()) for k, v in _grads(s).items()}
        if res is None:
            res = C.init_residuals(g)
        means, res = C.tree_compressed_psum(g, "data", res, mesh=mesh)
        steps.append(({k: v.numpy() for k, v in means.items()},
                      {k: v.numpy() for k, v in res.items()}))
    g = torch.from_numpy(_grads(0)["a"][r].copy())
    world = C.compressed_psum(g)
    codes = torch.full((1000,), 127 - r, dtype=torch.int32)
    total = all_reduce(codes, None, "sum")
    return dict(steps=steps, world=tuple(x.numpy() for x in world),
                total=total.numpy())


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(_rank, N, 1)


@pytest.fixture(scope="module")
def ref():
    """The reference's three steps under vmap over the data axis."""
    step = jax.jit(jax.vmap(
        lambda g, r: J.tree_compressed_psum(g, "data", r),
        axis_name="data"))
    res = J.init_residuals({k: jnp.asarray(v) for k, v in
                            _grads(0).items()})
    out = []
    for s in range(STEPS):
        means, res = step({k: jnp.asarray(v) for k, v in _grads(s).items()},
                          res)
        out.append((jax.tree.map(np.asarray, means),
                    jax.tree.map(np.asarray, res)))
    one = jax.jit(jax.vmap(lambda g: J.compressed_psum(g, "data"),
                           axis_name="data"))(jnp.asarray(_grads(0)["a"]))
    return dict(steps=out, world=tuple(np.asarray(x) for x in one))


@pytest.mark.parametrize("step", range(STEPS))
def test_tree_compressed_psum_bitwise(ranks, ref, step):
    """Every rank's means and residuals bitwise the reference's at each
    error-feedback step; the means alike on every rank."""
    want_m, want_r = ref["steps"][step]
    for r, rk in enumerate(ranks):
        got_m, got_r = rk["steps"][step]
        for k in SHAPES:
            assert np.array_equal(got_m[k], want_m[k][r]), (k, r)
            assert np.array_equal(got_r[k], want_r[k][r]), (k, r)
            assert np.array_equal(got_m[k], ranks[0]["steps"][step][0][k])


def test_compressed_psum_over_the_default_group(ranks, ref):
    """``compressed_psum`` over a process group (the default one) as over
    the mesh axis: bitwise the reference's."""
    for r, rk in enumerate(ranks):
        for got, want in zip(rk["world"], ref["world"]):
            assert np.array_equal(got, want[r])


def test_int32_totals_exact(ranks):
    """The payload sums as int32: 4 ranks of codes 127..124 total 502,
    exactly, on every rank."""
    for rk in ranks:
        assert rk["total"].dtype == np.int32
        assert (rk["total"] == sum(127 - r for r in range(N))).all()


def test_error_feedback_shrinks_the_mean_error(ranks):
    """The residual carries the quantization error: after the first step,
    the mean plus the mean of the residuals is the true mean to float32
    rounding."""
    g = _grads(0)
    means, _ = ranks[0]["steps"][0]
    for k in SHAPES:
        true = g[k].mean(0)
        res = sum(rk["steps"][0][1][k] for rk in ranks) / N
        np.testing.assert_allclose(means[k] + res, true, rtol=0,
                                   atol=1e-5 * max(1.0,
                                                   float(abs(true).max())))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_dequantize_bitwise(dtype):
    """``quantize`` (with and without a residual) and ``dequantize``
    against the reference's, jitted as it runs (XLA contracts its
    residual into a fused multiply-add): codes, scale and residual
    bitwise."""
    rng = np.random.default_rng(3)
    g = rng.standard_normal((33, 17)).astype(np.float32) * 3
    res = rng.standard_normal((33, 17)).astype(np.float32) * 0.01
    tg = torch.from_numpy(g).to(dtype)
    jg = jnp.asarray(tg.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    for r in (None, res):
        q, scale, nr = C.quantize(tg, None if r is None
                                  else torch.from_numpy(r))
        jq, js, jr = jax.jit(J.quantize)(jg, None if r is None
                                         else jnp.asarray(r))
        assert q.dtype == torch.int8
        assert np.array_equal(q.numpy(), np.asarray(jq))
        assert np.array_equal(scale.numpy(), np.asarray(js))
        assert np.array_equal(nr.numpy(), np.asarray(jr))
        assert np.array_equal(C.dequantize(q, scale).numpy(),
                              np.asarray(J.dequantize(jq, js)))


def test_wire_bytes_and_residuals():
    """``wire_bytes`` for the int8 payload and for float32 / bf16 leaves,
    and ``init_residuals``' float32 zeros, as the reference's."""
    tree = {k: torch.zeros(sh) for k, sh in SHAPES.items()}
    tree["h"] = torch.zeros(8, 3, dtype=torch.bfloat16)
    jtree = {k: jnp.zeros(tuple(v.shape), jnp.bfloat16 if v.dtype ==
                          torch.bfloat16 else jnp.float32)
             for k, v in tree.items()}
    for compressed in (True, False):
        assert C.wire_bytes(tree, compressed) == J.wire_bytes(jtree,
                                                              compressed)
    assert C.wire_bytes(tree, True) * 4 - 24 * 2 == C.wire_bytes(tree, False)
    res = C.init_residuals(tree)
    assert all(v.dtype == torch.float32 and not v.any()
               for v in res.values())
    assert {k: tuple(v.shape) for k, v in res.items()} == {
        k: tuple(v.shape) for k, v in tree.items()}

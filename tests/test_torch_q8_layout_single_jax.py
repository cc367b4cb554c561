"""B10 ``rb_spmv_q8``'s modelled block against the JAX package: moved
out of ``tests/test_torch_q8_layout.py`` unchanged, so that ``--dist
loadfile`` runs this file's cases, most of them in Pallas interpret mode
on the JAX side, beside that file's. The numpy model of the kernel's
block (``model_single``) is that file's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.packing import pack_from_dense, pad_packed
from repro.kernels import ops as jops
from repro.quant import formats as jqf
from repro_torch.kernels import ref
from repro_torch.models import packed_from_numpy
from repro_torch.quant import quantize_packed
from test_torch_q8_layout import _packed, model_single


# (B, ncols, ratio): B = 1-16 (NB = 4, 8, 16); int8 deltas (ncols ≤ 128:
# rows a row at a time), int16 (the stream); lstm_ptb's W_x and W_h
# (6000 gate rows of 375 and 750 entries over 1500 columns)
SINGLE = [(1, 100, 0.75), (3, 120, 0.5), (12, 300, 0.75), (16, 130, 0.5),
          (8, 1500, 0.75), (16, 1500, 0.5)]


@pytest.mark.parametrize("jbackend", ["pallas", "ref"])
@pytest.mark.parametrize("spec", ["int8", "q1.11"])
@pytest.mark.parametrize("B,ncols,ratio", SINGLE)
def test_modelled_single_q8_equals_jax(B, ncols, ratio, spec, jbackend):
    """The modelled B10 on the JAX package's own packing and codes equals
    the JAX rb_spmv_q8 (the Pallas kernel in interpret mode, or its plain
    reference) and the port's rb_spmv_q8_ref bit for bit: every row of
    every block, every batch row; int8 activations with a static scale,
    q1.11 with the scheme's own."""
    R = 4 * 1500 if ncols == 1500 else 4 * 97
    rng = np.random.default_rng(B * 11 + ncols + len(spec))
    K = int(round(ncols * (1 - ratio)))
    if ncols == 1500:   # lstm_ptb: row-balanced masks without the prune
        f = _packed(rng, R, ncols, K)
    else:
        w = (rng.normal(size=(R, ncols)) * ncols ** -0.5).astype(np.float32)
        f = pack_from_dense(jnp.asarray(w), ratio)
    js = pad_packed(jqf.quantize_packed(f, spec))
    assert np.asarray(js.deltas).dtype == (np.int8 if ncols <= 128
                                           else np.int16)
    x = jnp.asarray(rng.normal(size=(B, ncols)).astype(np.float32))
    scale = 0.05 if spec == "int8" else None
    want = jops.rb_spmv_q8(js, x, act_scale=scale, backend=jbackend)
    qx, sa = jops._quant_act(x, js, scale)
    comb = np.asarray(js.scales)[:R] * np.float32(sa)
    y, p = model_single((js.values, js.deltas), np.asarray(qx), comb, R)
    assert p.staged
    np.testing.assert_array_equal(y.view(np.uint32),
                                  np.asarray(want).view(np.uint32))
    ts = quantize_packed(packed_from_numpy(f.values, f.deltas, f.ncols,
                                           f.pad, f.block_rows), spec)
    plain = ref.rb_spmv_q8_ref(ts, torch.from_numpy(np.asarray(qx)),
                               torch.tensor(np.float32(sa)))
    np.testing.assert_array_equal(y.view(np.uint32),
                                  plain.numpy().view(np.uint32))

"""B7 ``rb_dual_parts_q8``'s modelled block against the JAX package: moved
out of ``tests/test_torch_q8_layout.py`` unchanged, so that ``--dist
loadfile`` runs this file's cases, most of them in Pallas interpret mode
on the JAX side, beside that file's. The numpy model of the kernel's
block (``model_dual_parts``) is that file's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.packing import pack_from_dense, pad_packed
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.quant import formats as jqf
from repro_torch.kernels import ref
from repro_torch.models import packed_from_numpy
from repro_torch.quant import quantize_packed
from test_torch_q8_layout import _packed, model_dual_parts


# (B, X, H): NB = 4, 8, 16; int8 deltas (X, H ≤ 128: rows a row at a
# time), int16 (the stream) and a mix (int8 for Sx, int16 for Sh);
# lstm_ptb's families (6000 rows of 375 and 750 entries over 1500)
DUAL = [(1, 100, 96), (3, 100, 300), (8, 300, 160), (16, 200, 130),
        (8, 1500, 1500)]


@pytest.mark.parametrize("jbackend", ["pallas", "ref"])
@pytest.mark.parametrize("spec", ["int8", "q1.11"])
@pytest.mark.parametrize("B,X,H", DUAL)
def test_modelled_dual_parts_equal_jax(B, X, H, spec, jbackend):
    """The modelled B7 on the JAX package's own packing and codes equals
    the JAX rb_dual_parts_q8 (Pallas, interpret mode, or its plain
    reference rb_spmv_q8_ref a family) and the port's rb_spmv_q8_ref bit
    for bit: zx and zh apart, every row of every block, every batch row."""
    R = 4 * H
    rng = np.random.default_rng(B * 7 + X + H + len(spec))
    arr = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    if X == 1500:   # lstm_ptb: row-balanced masks without the prune
        fx_, fh_ = _packed(rng, R, X, 375), _packed(rng, R, H, 750)
    else:
        fx_ = pack_from_dense(jnp.asarray(arr(R, X, sc=X ** -0.5)), 0.75)
        fh_ = pack_from_dense(jnp.asarray(arr(R, H, sc=H ** -0.5)), 0.5)
    jsx, jsh = (pad_packed(jqf.quantize_packed(f, spec)) for f in (fx_, fh_))
    x, h = arr(B, X), arr(B, H)
    qx, sax = jops._quant_act(jnp.asarray(x), jsx, 0.05 if spec == "int8"
                              else None)
    qh, sah = jops._quant_act(jnp.asarray(h), jsh, 0.04 if spec == "int8"
                              else None)
    if jbackend == "pallas":
        want = jops._dual_parts_q8(jsx, qx, sax, jsh, qh, sah, 256)
    else:
        want = (jref.rb_spmv_q8_ref(jsx, qx, sax),
                jref.rb_spmv_q8_ref(jsh, qh, sah))
    comb = [np.asarray(s.scales)[:R] * np.float32(a)
            for s, a in ((jsx, sax), (jsh, sah))]
    zx, zh, p = model_dual_parts((jsx.values, jsx.deltas),
                                 (jsh.values, jsh.deltas), np.asarray(qx),
                                 np.asarray(qh), *comb, R)
    assert p.staged
    for got, w in zip((zx, zh), want):
        np.testing.assert_array_equal(got.view(np.uint32),
                                      np.asarray(w).view(np.uint32))
    tsx, tsh = (quantize_packed(packed_from_numpy(
        f.values, f.deltas, f.ncols, f.pad, f.block_rows), spec)
        for f in (fx_, fh_))
    for ts, js in ((tsx, jsx), (tsh, jsh)):
        np.testing.assert_array_equal(ts.values.numpy(),
                                      np.asarray(js.values)[:ts.rows])
    for ts, q, a, got in ((tsx, qx, sax, zx), (tsh, qh, sah, zh)):
        plain = ref.rb_spmv_q8_ref(ts, torch.from_numpy(np.asarray(q)),
                                   torch.tensor(np.float32(a)))
        np.testing.assert_array_equal(got.view(np.uint32),
                                      plain.numpy().view(np.uint32))

"""Three faults of the port against the reference, held repaired.

* Gradient accumulation adds each microbatch into one set of float32
  accumulators in place, and the sharded step drops each accumulator as
  soon as its reduced copy exists: on the dry run's storage tracker
  (``launch.dryrun.trace_step``, rank 0 of a fake (1, 2) mesh) the step's
  temp bytes fall by at least one float32 copy of the rank's gradients
  against the former form (a new list a microbatch, the accumulators held
  through the reduce), and the loss, the gradients and the updated params
  are bitwise the former form's.
* The sharded step all-reduces bf16 gradients in bf16, as the reference
  keeps the param dtype there: at a batch axis of 2 gloo's bf16 sum is
  bitwise the float32 sum cast back, and the sharded bf16 step at (2, 2)
  stays within ``BF16_GRAD_ATOL`` of one device's.
* ``kernels.ops``' wrappers take the reference's deprecated
  ``use_kernel=`` (True → "auto", False → "ref", a DeprecationWarning)
  and refuse its Pallas tiling knobs by name.
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

from repro_torch.training import train_loop as TL
from repro_torch.training.tree import leaves, unflatten

ACCUM = 4
# the sharded bf16 step's gradients against one device's, of each leaf's
# max: the tensor-parallel forward and backward round their bf16 partial
# sums in another order (measured 1.37e-2 at (2, 2) on the smoke qwen3 in
# bf16, 3.5 bf16 ulps of a leaf's max; the batch axis's reduce adds no
# bit to it, as the first check shows)
BF16_GRAD_ATOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _former_loss_and_grads(held):
    """``loss_and_grads`` as it was: a new float32 list a microbatch, the
    accumulators kept alive (in ``held``) until the step is over, as the
    former sharded step's reduce held them."""
    def fn(model, accum, params, batch):
        if accum == 1:
            return TL.value_and_grad(model.loss, params, batch)

        def mb(i):
            return {k: v.reshape(accum, v.shape[0] // accum,
                                 *v.shape[1:])[i] for k, v in batch.items()}
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in leaves(params)]
        loss = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        for i in range(accum):
            l, g = TL.value_and_grad(model.loss, params, mb(i))
            grads = [a + b.float() / accum for a, b in zip(grads, leaves(g))]
            loss = loss + l / accum
        held.append(grads)
        return loss, unflatten(params, grads)
    return fn


def test_accumulation_temp_falls_by_a_gradient_copy(monkeypatch):
    """The dry run's trace of a train step with grad_accum 4 (the smoke
    qwen3, float32, B=8, S=16) on rank 0 of a fake (1, 2) mesh: its temp
    bytes at least one float32 copy of the rank's gradient pieces below
    the former form's."""
    from repro_torch.configs import SHAPES, smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.serve import rank_param_bytes
    arch = smoke_config("qwen3-0.6b").with_(grad_accum=ACCUM)
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=8,
                                seq_len=16)
    mesh = dryrun._mesh(False, (1, 2))
    model = dryrun._model(arch)
    now = dryrun.trace_step(mesh, arch, model, shape)["temp_bytes"]
    held = []
    monkeypatch.setattr(TL, "loss_and_grads", _former_loss_and_grads(held))
    before = dryrun.trace_step(mesh, arch, model, shape)["temp_bytes"]
    held.clear()
    copy = rank_param_bytes(model, TL.param_shardings(mesh, model))
    assert before - now >= copy, (before, now, copy)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_accumulation_bitwise_the_former_form(dtype):
    """One device, grad_accum 4: the loss, every gradient and the params
    after a ``make_train_step`` step bitwise the former form's."""
    import types
    from repro_torch.configs import smoke_config
    from repro_torch.models import build_model
    from repro_torch.training import OptConfig, init_state
    from repro_torch.training.train_loop import make_train_step
    model = build_model(smoke_config("qwen3-0.6b").with_(dtype=dtype))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    raw = torch.as_tensor(np.random.default_rng(2).integers(
        0, model.cfg.vocab_size, (8, 12)))
    batch = {"tokens": raw, "labels": raw}
    l1, g1 = TL.loss_and_grads(model, ACCUM, params, batch)
    l0, g0 = _former_loss_and_grads([])(model, ACCUM, params, batch)
    assert torch.equal(l1, l0)
    assert all(torch.equal(a, b) for a, b in zip(leaves(g1), leaves(g0)))
    cfg, oc = types.SimpleNamespace(grad_accum=ACCUM), OptConfig()
    step = make_train_step(model, cfg, oc)
    p1, _, m1 = step(params, init_state(oc, params), batch, 1)
    real = TL.loss_and_grads
    TL.loss_and_grads = _former_loss_and_grads([])
    try:
        p0, _, m0 = step(params, init_state(oc, params), batch, 1)
    finally:
        TL.loss_and_grads = real
    assert torch.equal(m1["loss"], m0["loss"])
    assert all(torch.equal(a, b) for a, b in zip(leaves(p1), leaves(p0)))


def _bf16_rank(mesh):
    """(gloo's bf16 all-reduce over ``data`` bitwise the float32 sum cast
    back, the sharded bf16 step's worst gradient gap of a leaf's max
    against one device's, every gradient in its param's dtype)."""
    import types
    from repro_torch.configs import smoke_config
    from repro_torch.dist.collective_ops import all_reduce_axis, full_tensor
    from repro_torch.models import build_model
    from repro_torch.training import OptConfig, jit_train_step
    g = torch.Generator().manual_seed(10 + mesh.get_local_rank("data"))
    t = torch.randn(4096, generator=g).to(torch.bfloat16)
    same = torch.equal(all_reduce_axis(t, mesh, "data"),
                       all_reduce_axis(t.float(), mesh, "data").to(t.dtype))
    model = build_model(smoke_config("qwen3-0.6b").with_(dtype="bfloat16"))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    raw = torch.as_tensor(np.random.default_rng(1).integers(
        0, model.cfg.vocab_size, (4, 8)))
    batch = {"tokens": raw, "labels": raw}
    step = jit_train_step(mesh, model, types.SimpleNamespace(grad_accum=1),
                          OptConfig(), batch)
    _, grads = step.grads(params, batch)
    _, g1 = TL.value_and_grad(model.loss, params, batch)
    gap = max(float((full_tensor(a).float() - b.float()).abs().max()
                    / b.float().abs().max().clamp_min(1e-30))
              for a, b in zip(leaves(grads), leaves(g1)))
    own = all(a.dtype == p.dtype for a, p in zip(leaves(grads),
                                                 leaves(params)))
    return same, gap, own


def test_bf16_gradients_reduce_in_bf16():
    """At (2, 2): gloo's bf16 sum over the batch axis of 2 is bitwise the
    float32 sum cast back (so reducing in the gradient's own dtype changes
    no bit there); the sharded bf16 step's gradients keep their params'
dtypes (bf16 weights, float32 qk-norms) and stay within
    ``BF16_GRAD_ATOL`` of a leaf's max of one device's."""
    from repro_torch.launch.mesh import run_ranks
    for same, gap, own in run_ranks(_bf16_rank, 2, 2):
        assert same and own
        assert gap <= BF16_GRAD_ATOL, gap


def _use_kernel_calls():
    from repro_torch.core.packing import pack_from_dense
    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(0)
    s = pack_from_dense(torch.randn(8, 16, generator=g), 0.5)
    x, h = torch.randn(2, 16, generator=g), torch.randn(2, 16, generator=g)
    z = torch.randn(2, 4, generator=g)
    q, k = torch.randn(2, 4, 3, 32, generator=g), torch.randn(2, 2, 3, 32,
                                                             generator=g)
    n = torch.full((2,), 3, dtype=torch.int32)
    return {
        "rb_spmv": lambda **kw: ops.rb_spmv(s, x, **kw),
        "rb_dual_spmv": lambda **kw: ops.rb_dual_spmv(
            s, x, s, h, torch.zeros(8), **kw),
        "lstm_gates": lambda **kw: ops.lstm_gates(z, z, z, z, z, **kw),
        "flash_attention": lambda **kw: ops.flash_attention(q, k, k, **kw),
        "decode_attention": lambda **kw: ops.decode_attention(
            q[:, :, 0], k, k, n, **kw)}


@pytest.mark.parametrize("name", ["rb_spmv", "rb_dual_spmv", "lstm_gates",
                                  "flash_attention", "decode_attention"])
def test_use_kernel_alias(name):
    """``use_kernel=True`` / ``False``: a DeprecationWarning each, the
    result the "auto" / "ref" backend's (on a CPU tensor both are the
    plain version); ``from_use_kernel`` maps them so."""
    from repro_torch.sparse import backend
    call = _use_kernel_calls()[name]
    want = call(backend="ref")
    for flag in (True, False):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            got = call(use_kernel=flag)
        assert [w.category for w in seen] == [DeprecationWarning]
        assert seen[0].filename == __file__
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(a, b)
    with pytest.warns(DeprecationWarning, match="use_kernel"):
        assert backend.from_use_kernel(True) == "auto"
    with pytest.warns(DeprecationWarning):
        assert backend.from_use_kernel(False) == "ref"


@pytest.mark.parametrize("name,knob", [
    ("rb_spmv", "block_rows"), ("rb_dual_spmv", "block_rows"),
    ("flash_attention", "block_q"), ("flash_attention", "block_kv"),
    ("decode_attention", "block_kv")])
def test_tiling_knobs_refused_by_name(name, knob):
    """The reference's Pallas tiling knobs raise, naming the knob and the
    port's launch plans."""
    call = _use_kernel_calls()[name]
    with pytest.raises(TypeError, match=f"{knob}=.*kernels/plan.py"):
        call(**{knob: 128})

"""Production dry run: every (architecture × input shape) cell on the
production meshes, traced as one rank of them, with no card and no other
process. The port of ``repro/launch/dryrun.py``.

The reference lowers and compiles each cell on 256 / 512 host devices and
reads the compiled artifact. Here one process is rank 0 of the mesh: a
``torch.distributed`` group on the "fake" backend of 256 (``pod16x16``)
or 512 (``pod2x16x16``) ranks (``launch.mesh.make_production_mesh(
backend="fake")``), whose collectives return at once, and the cell's real
step runs under ``FakeTensorMode`` on fake tensors: nothing is allocated
and no kernel runs (``kernels.ops``' fakes stand in for the 15 kernels).
The step is the port's own:

* train: ``training.jit_train_step`` (tensor-parallel forms, ZeRO-1
  moments, the batch split over the batch axes) on the rank's pieces;
* prefill / decode: ``TransformerLM.with_mesh`` (the tensor-parallel
  prefill, the split-KV decode step over the rank's cache segment and
  recurrent state slices).

What the trace reads, per cell (the reference's record, from the traced
step where the reference reads the compiled one):

* ``memory``: ``argument_bytes`` (this rank's param pieces, ZeRO-1
  moments, and batch or cache pieces), ``output_bytes``, ``temp_bytes``
  (the peak of live fake storage above the arguments during the step)
  and ``fits`` against ``hw.HBM_PER_CHIP``; each storage counted as the
  card's caching allocator rounds it (up to 512 bytes);
* ``flops_per_chip``: ``aten`` (``FlopCounterMode``'s count) and ``kernels``
  (the fakes' ``ops.KERNEL_FLOPS``), each by the rate it runs at;
* ``model_flops``, ``useful_flops_ratio``; ``hbm_bytes``
  (``roofline.analytic_hbm_bytes``, packed weights in place of dense
  ones under ``--brds``);
* ``collectives``: each collective the step stages
  (``dist.collective_ops.recording``) by kind and mesh axis, with its
  bytes and count, and ``collective_wire_bytes`` (ring: (n-1)/n of the
  payload, 2(n-1)/n for an all-reduce);
* ``roofline``: ``compute_s`` at ``hw``'s bf16 / fp32 / int8 rates,
  ``memory_s`` at ``hw.HBM_BW``, ``collective_s`` at the slowest link a
  group spans (``hw.link_bw``: NVLink in a node of eight, InfiniBand
  across), ``bound`` and ``step_s`` (the largest term);
* ``trace_s``.

A cell whose path the port refuses (``--brds``: no transformer forward
takes packed rows) is recorded ``not_ported`` with the refusal's words; a
cell the reference's ``runnable`` rules out, ``n/a``. Every family's train
cell runs the tensor-parallel step, its loss on the rank's vocabulary
columns (``TensorParallel.cross_entropy``). The reference's HLO
half
(``compile()``, its memory and cost analyses, ``--hlo-dir``,
``roofline.analyze_hlo``) has no counterpart.

Fake card tensors need a torch built with CUDA (autograd and some
scalar ops ask for the card's device guard); elsewhere a cell traces on
fake CPU tensors that stand for card tensors (``ops.fakes_as_card``: the
entry points take their kernels' fakes on them), ``trace_device`` in the
record. Both hold the same bytes, FLOPs and collectives.

Results are JSON a cell under ``reports/dryrun_torch`` (``--out``);
rerunning skips the cells already there (``--force`` recomputes).

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
        [--shape S] [--mesh single|multi|both] [--brds] [--kv-quant]

``--mesh-shape D,M`` with ``--batch`` / ``--seq`` traces a cell on a
(data, model) mesh of D·M ranks at another batch and length (any
``LSTM_CONFIGS`` name as ``--arch`` too): ``chip_smoke.py`` holds such
traces against what its sharded phase measures on real ranks.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
import types
import weakref

import torch

__all__ = ["NotPorted", "cell_config", "held_bytes", "refusal",
           "build_cell", "trace_step", "run_cell", "main"]

OUT = "reports/dryrun_torch"
MESH_TAGS = {False: "pod16x16", True: "pod2x16x16"}
ALLOC_ROUND = 512        # the card's caching allocator rounds each block up


class NotPorted(Exception):
    """A cell whose path the port refuses; the message is the refusal's."""


# ------------------------------------------------------------------ cells

def _is_lstm(name: str) -> bool:
    from ..models import LSTM_CONFIGS
    return name in LSTM_CONFIGS


def _lstm_cfg(arch) -> bool:
    """An LSTMConfig (the paper's LSTMs), not an ArchConfig."""
    return hasattr(arch, "hidden")


def cell_config(arch_name: str, shape_name: str, multi_pod: bool = False,
                overrides: dict | None = None, *, mesh_shape=None,
                batch: int | None = None, seq: int | None = None):
    """(arch, shape, brds, n_devices) of a cell: the reference's dp → tp
    rule applied (decode keeps TP; train keeps DP only when the batch
    covers every rank; prefill keeps DP only for a MoE), ``--batch`` /
    ``--seq`` over the shape. An LSTM name gives its ``LSTMConfig``."""
    from ..configs import SHAPES, get_arch
    from ..models import LSTM_CONFIGS
    ov = dict(overrides or {})
    brds = bool(ov.pop("brds", False))
    shape = SHAPES[shape_name]
    if batch is not None or seq is not None:
        b, s = batch or shape.global_batch, seq or shape.seq_len
        shape = dataclasses.replace(shape, name=f"{shape.kind}_b{b}_s{s}",
                                    global_batch=b, seq_len=s)
    n_total = (math.prod(mesh_shape) if mesh_shape else
               512 if multi_pod else 256)
    if _is_lstm(arch_name):
        return LSTM_CONFIGS[arch_name], shape, brds, n_total
    arch = get_arch(arch_name)
    if ov:
        arch = arch.with_(**ov)
    if arch.layout == "dp" and (
            shape.kind == "decode"
            or (shape.kind == "train" and shape.global_batch % n_total)
            or (shape.kind == "prefill" and not arch.moe)):
        arch = arch.with_(layout="tp")
    return arch, shape, brds, n_total


def _mesh(multi_pod: bool, mesh_shape=None):
    """The cell's mesh over a fake group, this process rank 0."""
    from .mesh import AXES, init_fake_group, make_mesh, make_production_mesh
    if mesh_shape is None:
        return make_production_mesh(multi_pod=multi_pod,
                                    device=_trace_device(), backend="fake")
    init_fake_group(math.prod(mesh_shape))
    return make_mesh(tuple(mesh_shape), AXES, device=_trace_device(),
                     backend="fake")


def _model(arch):
    from ..models import LSTMModel, build_model
    return LSTMModel(arch) if _lstm_cfg(arch) else build_model(arch)


def _rules(arch):
    from ..sharding import DEFAULT_RULES, rules_for, use_rules
    return use_rules(DEFAULT_RULES if _lstm_cfg(arch) else rules_for(arch))


def _local_shape(shape, placements, mesh) -> tuple:
    """The piece of a ``shape`` tensor one rank holds under ``placements``
    (the rule table splits only dims the axis sizes divide)."""
    out = list(shape)
    for i, pl in enumerate(placements):
        if pl.is_shard():
            out[pl.dim] //= mesh.size(i)
    return tuple(out)


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def _shardings(mesh, arch, model, shape):
    """(param, ZeRO-1 moment, batch or cache shardings, the batch or cache
    stand-ins) of a cell: the rule table's, under the cell's layout."""
    from ..models import layers as L
    from ..serving.engine import cache_shardings
    from ..sharding import NamedSharding
    from ..training import OptConfig
    from ..training.train_loop import (batch_shardings, opt_shardings,
                                       param_shardings)
    from .specs import input_specs
    defs = model.param_defs()
    with _rules(arch):
        p_sh = param_shardings(mesh, model)
        o_sh = opt_shardings(mesh, OptConfig(), p_sh, defs,
                             zero1=getattr(arch, "zero1", True))
        B, S = shape.global_batch, shape.seq_len
        if shape.kind == "decode":
            data = L.abstract_params(model.cache_defs(B, S))
            place = cache_shardings(mesh, model, B, S)
            d_sh = _map_placements(lambda pl: NamedSharding(mesh, pl),
                                   place)
        else:
            data = (_lstm_batch(B, S, "meta") if _lstm_cfg(arch)
                    else input_specs(arch, shape))
            if shape.kind == "prefill":
                data = {k: v for k, v in data.items() if k != "labels"}
            d_sh = batch_shardings(mesh, data)
    return p_sh, o_sh, d_sh, data


def _map_placements(fn, tree):
    """``fn`` over a tree of placement tuples (dicts and lists of them)."""
    if isinstance(tree, dict):
        return {k: _map_placements(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_placements(fn, v) for v in tree]
    return fn(tree)


def _lstm_batch(B: int, T: int, device) -> dict:
    """An LSTM language model's batch: token ids (B, T) int32, as the
    corpora give them."""
    return {k: torch.empty((B, T), dtype=torch.int32, device=device)
            for k in ("inputs", "labels")}


def held_bytes(arch_name: str, shape_name: str, multi_pod: bool = False,
               overrides: dict | None = None, *, mesh_shape=None,
               batch: int | None = None, seq: int | None = None) -> dict:
    """The bytes rank 0 holds of the cell's params, ZeRO-1 moments (m and
    v) and, for a decode shape, its cache, from the shardings alone (no
    step is traced): the figures the reference's ``shard_shape``s give."""
    from ..training.tree import leaves
    arch, shape, _, _ = cell_config(arch_name, shape_name, multi_pod,
                                    overrides, mesh_shape=mesh_shape,
                                    batch=batch, seq=seq)
    mesh = _mesh(multi_pod, mesh_shape)
    model = _model(arch)
    p_sh, o_sh, d_sh, data = _shardings(mesh, arch, model, shape)
    defs = leaves(model.param_defs())
    out = {
        "params": sum(_nbytes(_local_shape(d.shape, sh.placements, mesh),
                              d.dtype) for d, sh in zip(defs, leaves(p_sh))),
        "moments": sum(2 * _nbytes(_local_shape(d.shape, sh.placements,
                                                mesh), torch.float32)
                       for d, sh in zip(defs, leaves(o_sh["m"])))}
    if shape.kind == "decode":
        out["cache"] = sum(
            _nbytes(_local_shape(t.shape, sh.placements, mesh), t.dtype)
            for t, sh in zip(leaves(data), leaves(d_sh)))
    return out


def refusal(arch_name: str, shape_name: str, multi_pod: bool = False,
            overrides: dict | None = None) -> str | None:
    """The port's refusal of the cell's path, in its own words, or None:
    the reference's ``runnable`` cells whose step the port does not run
    on the production mesh."""
    arch, shape, _, _ = cell_config(arch_name, shape_name, multi_pod,
                                    overrides)
    mesh = _mesh(multi_pod)
    try:
        _refuse(mesh, arch, _model(arch), shape)
    except NotPorted as e:
        return str(e)
    return None


def _refuse(mesh, arch, model, shape):
    """Raise ``NotPorted`` with the port's refusal of this cell's path;
    return the model the step runs (over the mesh)."""
    if shape.kind == "train":
        return model.with_mesh(mesh)
    if _lstm_cfg(arch):
        raise NotPorted(
            f"{arch.name}: the dry run traces an LSTM's train step; its "
            "sharded decode serves packed rows (ServeEngine(mesh=)), which "
            "it does not build")
    if arch.layout == "dp":
        # a mixture's prefill keeps the "dp" layout (cell_config): params
        # whole, the batch over every rank, the one-device prefill
        return model
    try:
        net = model.with_mesh(mesh)
        net.cache_defs(1, shape.seq_len)
    except NotImplementedError as e:
        raise NotPorted(str(e)) from None
    return net


# ------------------------------------------------------------- tracing

def _rounded(n: int) -> int:
    return -(-n // ALLOC_ROUND) * ALLOC_ROUND


class _Trace(torch.utils._python_dispatch.TorchDispatchMode):
    """Live fake storage (each counted once, rounded as the allocator
    rounds it, until it is freed) and its peak, and the aten FLOPs that
    ``FlopCounterMode`` counts (its formulas, ``flop_registry``, op for
    op), by the dtype of each op's first operand. One mode in place of
    ``FlopCounterMode`` beside it: a trace pays each mode on every op."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.live = self.peak = self.flops = 0
        self.seen: set = set()
        self.by_dtype: dict = {}

    def add(self, t) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self.seen:
            return
        n = _rounded(st.nbytes())
        self.seen.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key, n) -> None:
        self.seen.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if isinstance(out, torch.Tensor):
            self.add(out)
        elif isinstance(out, (tuple, list)):
            for t in torch.utils._pytree.tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self.add(t)
        count = self.registry.get(func._overloadpacket)
        if count is not None:
            first = next(t for t in torch.utils._pytree.tree_leaves(args)
                         if isinstance(t, torch.Tensor))
            kind = ("bf16" if first.dtype in (torch.bfloat16, torch.float16)
                    else "int8" if not first.dtype.is_floating_point
                    else "fp32")
            n = int(count(*args, **kwargs, out_val=out))
            self.by_dtype[kind] = self.by_dtype.get(kind, 0) + n
            self.flops += n
        return out


def _storages_bytes(tree, skip=frozenset()) -> int:
    """Rounded bytes of the distinct storages of ``tree``'s tensors (a
    DTensor's local piece), those of ``skip`` left out."""
    from ..training.tree import leaves
    seen, total = set(skip), 0
    for t in leaves(tree):
        if not isinstance(t, torch.Tensor):
            continue
        t = t.to_local() if hasattr(t, "to_local") else t
        key = id(t.untyped_storage())
        if key not in seen:
            seen.add(key)
            total += _rounded(t.untyped_storage().nbytes())
    return total


def _storage_ids(tree) -> set:
    from ..training.tree import leaves
    return {id((t.to_local() if hasattr(t, "to_local") else t)
               .untyped_storage())
            for t in leaves(tree) if isinstance(t, torch.Tensor)}


def _pieces(mesh, shardings, shapes_dtypes, device):
    """DTensors of fake local pieces: each leaf's piece under its
    sharding, of its dtype, on ``device``."""
    from ..dist.collective_ops import to_dtensor
    from ..training.tree import leaves, unflatten
    out = []
    for sh, (shape, dtype) in zip(leaves(shardings), shapes_dtypes):
        local = torch.empty(_local_shape(shape, sh.placements, mesh),
                            dtype=dtype, device=device)
        out.append(to_dtensor(local, mesh, sh.placements, shape))
    return unflatten(shardings, out)


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


def _trace_device() -> str:
    """The fake tensors' device: the card's where torch is built with CUDA
    (fake card tensors need its device guard), else the CPU's."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def _summarize_collectives(records) -> tuple[dict, float, float]:
    """({kind/axis: {count, bytes, wire, ranks, link}}, wire bytes,
    seconds at the slowest link each group spans)."""
    from .. import hw
    out, wire_total, secs = {}, 0.0, 0.0
    for r in records:
        n = len(r["ranks"])
        wire = (2 if r["kind"] == "all-reduce" else 1) * r["bytes"] \
            * (n - 1) / n
        bw = hw.link_bw(r["ranks"])
        key = f"{r['kind']}/{r['axis']}"
        e = out.setdefault(key, {"kind": r["kind"], "axis": r["axis"],
                                 "ranks": n, "count": 0, "bytes": 0,
                                 "wire": 0.0, "link": ("nvlink"
                                                       if bw == hw.NVLINK_BW
                                                       else "ib")})
        e["count"] += 1
        e["bytes"] += r["bytes"]
        e["wire"] += wire
        wire_total += wire
        secs += wire / bw
    return out, wire_total, secs


def _packed_held(mesh, packed, p_sh) -> int:
    """The bytes rank 0 holds of a packed param tree (``plan.pack(...,
    abstract=True)``'s): a leaf the plan left keeps its sharding; a packed
    rep's tensors split their row dim (the one before last) over
    ``model`` where it divides, as the reference's ``_packed_shardings``
    lays them out."""
    from ..sharding import mesh_axes
    from ..sparse.policy import _leaves_with_path
    orig = dict(_leaves_with_path(p_sh))
    n = mesh_axes(mesh).get("model", 1)
    total = 0
    for ps, leaf in _leaves_with_path(packed):
        if isinstance(leaf, torch.Tensor):
            total += _nbytes(_local_shape(leaf.shape, orig[ps].placements,
                                          mesh), leaf.dtype)
            continue
        for f in dataclasses.fields(leaf):
            t = getattr(leaf, f.name)
            if isinstance(t, torch.Tensor):
                shape = list(t.shape)
                if len(shape) >= 2 and shape[-2] % n == 0:
                    shape[-2] //= n
                total += _nbytes(shape, t.dtype)
    return total


def _brds_hbm(arch, shape, n_dev: int, report: dict) -> dict:
    """``roofline.analytic_hbm_bytes`` with the packed weights' bytes in
    place of the dense ones (the reference's BRDS adjustment)."""
    from .. import roofline
    hbm = roofline.analytic_hbm_bytes(arch, shape, n_dev)
    delta = (report["dense_bytes"] - report["packed_bytes"]) / n_dev
    hbm["weights"] = max(hbm["weights"] - delta, 0.0)
    hbm["total_per_chip"] = max(hbm["total_per_chip"] - delta, 0.0)
    hbm["brds_packed_ratio"] = report["ratio"]
    return hbm


def build_cell(arch_name: str, shape_name: str, multi_pod: bool = False,
               overrides: dict | None = None, *, mesh_shape=None,
               batch: int | None = None, seq: int | None = None) -> dict:
    """Trace one cell's step as rank 0 of its mesh on fake tensors
    (``trace_step``). Returns the trace with the cell's arch, shape,
    n_devices and ``trace_s``. Raises ``NotPorted`` where the port
    refuses the cell's path (under ``--brds``, with the pack report and
    the packed params' bytes a rank as its ``brds`` / ``held``)."""
    arch, shape, brds, n_dev = cell_config(
        arch_name, shape_name, multi_pod, overrides, mesh_shape=mesh_shape,
        batch=batch, seq=seq)
    t0 = time.perf_counter()
    mesh = _mesh(multi_pod, mesh_shape)
    model = _model(arch)
    if brds:
        from ..sparse import transformer_policy
        with _rules(arch):
            from ..training.train_loop import param_shardings
            p_sh = param_shardings(mesh, model)
        bc = arch.brds
        abs_params = model.abstract_params()
        packed, report = transformer_policy(bc.spar_a, bc.spar_b).compile(
            abs_params).pack(abs_params, abstract=True)
        e = NotPorted(
            f"{arch.name}: --brds packs the weights, and no transformer "
            "forward in either package takes packed rows (the zoo serves "
            "BRDS as pruned dense weights, launch.serve --brds)")
        e.brds, e.held = report, _packed_held(mesh, packed, p_sh)
        e.hbm = _brds_hbm(arch, shape, n_dev, report)
        raise e
    tr = trace_step(mesh, arch, model, shape)
    tr.update(arch=arch, shape=shape, n_devices=n_dev,
              trace_s=time.perf_counter() - t0)
    return tr


def trace_step(mesh, arch, model, shape) -> dict:
    """Run ``shape.kind``'s step of ``model`` (``arch``: its ArchConfig,
    or an LSTMConfig) as rank 0 of ``mesh`` (over a fake group) on fake
    tensors: the train step on the rank's param, moment and batch pieces;
    the prefill on its batch rows; the decode step on its rows and cache
    segment. Returns what the trace read: ``argument_bytes``,
    ``output_bytes``, ``temp_bytes``, ``held`` (the arguments' bytes by
    kind, unrounded), ``aten_flops`` (and ``aten_by_dtype``), the
    kernels' fakes' ``kernels``, the staged ``collectives`` and
    ``trace_device``. Raises ``NotPorted`` where the port refuses the
    path."""
    from ..dist.collective_ops import recording, to_dtensor
    from ..kernels import ops
    from ..models import layers as L
    from ..training import OptConfig, jit_train_step
    from ..training.tree import leaves
    p_sh, o_sh, d_sh, data = _shardings(mesh, arch, model, shape)
    net = _refuse(mesh, arch, model, shape)
    defs = leaves(model.param_defs())
    device = _trace_device()
    ops.reset_kernel_flops()
    trace = _Trace()
    with _fake_mode(), ops.fakes_as_card(), trace, recording() as colls:
        params = _pieces(mesh, p_sh, [(d.shape, d.dtype) for d in defs],
                         device)
        B, S = shape.global_batch, shape.seq_len
        if shape.kind == "train":
            opt = {k: (_pieces(mesh, o_sh[k], [(d.shape, torch.float32)
                                               for d in defs], device)
                       if k != "count" else
                       to_dtensor(torch.zeros((), dtype=torch.int32,
                                              device=device), mesh,
                                  o_sh[k].placements, ()))
                   for k in o_sh}
            args = {"params": params, "opt": opt,
                    "batch": _pieces(mesh, d_sh, [(v.shape, v.dtype) for v
                                                  in leaves(data)], device)}
        elif shape.kind == "prefill":
            rows = _rows(mesh, d_sh, B)
            args = {"params": params,
                    "batch": {k: torch.empty((rows, *v.shape[1:]),
                                             dtype=v.dtype, device=device)
                              for k, v in data.items()}}
        else:
            rows = _rows(mesh, d_sh, B)
            args = {"params": params,
                    "cache": L.abstract_params(net.cache_defs(rows, S),
                                               device),
                    "tokens": torch.empty((rows, 1), dtype=torch.int32,
                                          device=device),
                    "pos": torch.empty((), dtype=torch.int32,
                                       device=device)}
        held = {k: sum(_local(t).nbytes for t in leaves(v))
                for k, v in args.items() if k != "opt"}
        if "opt" in args:
            held["moments"] = sum(_local(t).nbytes for k in ("m", "v")
                                  if k in args["opt"]
                                  for t in leaves(args["opt"][k]))
            held["count"] = _local(args["opt"]["count"]).nbytes
        arg_ids = _storage_ids(args)
        arg_bytes = _storages_bytes(args)
        live0, flops0, by0 = trace.live, trace.flops, dict(trace.by_dtype)
        del colls[:]
        with _rules(arch):
            if shape.kind == "train":
                # an LSTMConfig carries no training system: one
                # microbatch, ZeRO-1, as chip_smoke's sharded phase runs it
                step_cfg = (arch if hasattr(arch, "grad_accum") else
                            types.SimpleNamespace(grad_accum=1, zero1=True))
                step = jit_train_step(mesh, model, step_cfg, OptConfig(),
                                      data)
                out = step(args["params"], args["opt"], args["batch"], 1)
            elif shape.kind == "prefill":
                b = args["batch"]
                extra = b.get("frames", b.get("patch_embeds"))
                out = net.prefill(params, b["tokens"], S, extra=extra)
            else:
                out = net.decode_step(params, args["cache"], args["tokens"],
                                      args["pos"])
        out_bytes = _storages_bytes(out, skip=arg_ids)
        temp = trace.peak - live0
        aten = trace.flops - flops0
        by_dtype = {k: v - by0.get(k, 0) for k, v in trace.by_dtype.items()}
        records = list(colls)
        del out, args, params
    return dict(mesh_axes=dict(zip(mesh.mesh_dim_names, mesh.shape)),
                trace_device=device, argument_bytes=arg_bytes,
                output_bytes=out_bytes, temp_bytes=temp, held=held,
                aten_flops=aten, aten_by_dtype=by_dtype,
                kernels={k: dict(v) for k, v in ops.KERNEL_FLOPS.items()},
                collectives=records)


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def _rows(mesh, d_sh, B: int) -> int:
    """The rows of a ``B``-row batch rank 0 holds: B over the mesh axes
    that split the first dim of the batch's (or the cache's) first leaf."""
    from ..training.tree import leaves
    sh = leaves(d_sh)[0]
    return B // math.prod(mesh.size(i) for i, pl in enumerate(sh.placements)
                          if pl.is_shard() and pl.dim == 0)


# ------------------------------------------------------------- records

def _record(tr: dict) -> dict:
    """The JSON record of a traced cell (see the module docstring)."""
    from .. import hw, roofline
    arch, shape, n_dev = tr["arch"], tr["shape"], tr["n_devices"]
    k_tot = {r: sum(v[r] for v in tr["kernels"].values())
             for r in ("fp32", "int8", "bf16")}
    total = tr["aten_flops"] + sum(k_tot.values())
    mem = dict(argument_bytes=tr["argument_bytes"],
               output_bytes=tr["output_bytes"], temp_bytes=tr["temp_bytes"],
               held=tr["held"])
    mem["peak_bytes"] = mem["argument_bytes"] + mem["temp_bytes"]
    mem["fits"] = mem["peak_bytes"] <= hw.HBM_PER_CHIP
    lstm = _lstm_cfg(arch)
    mflops = None if lstm else roofline.model_flops(arch, shape)
    if lstm:
        hbm = {"total_per_chip": mem["argument_bytes"] + mem["output_bytes"],
               "source": "the traced arguments and outputs"}
    else:
        hbm = roofline.analytic_hbm_bytes(arch, shape, n_dev)
    colls, wire, coll_s = _summarize_collectives(tr["collectives"])
    a = tr["aten_by_dtype"]
    compute_s = ((a.get("bf16", 0) + k_tot["bf16"]) / hw.PEAK_BF16_FLOPS
                 + (a.get("fp32", 0) + k_tot["fp32"]) / hw.PEAK_FP32_FLOPS
                 + (a.get("int8", 0) + k_tot["int8"]) / hw.PEAK_INT8_OPS)
    memory_s = hbm["total_per_chip"] / hw.HBM_BW
    dom = max(compute_s, memory_s, coll_s)
    bound = ("compute" if dom == compute_s else
             "memory" if dom == memory_s else "collective")
    return dict(
        status="ok", n_devices=n_dev, mesh_axes=tr["mesh_axes"],
        trace_device=tr["trace_device"], trace_s=round(tr["trace_s"], 2),
        memory=mem,
        flops_per_chip=dict(aten=tr["aten_flops"], aten_by_dtype=a,
                            kernels=tr["kernels"], kernels_total=k_tot,
                            total=total),
        model_flops=mflops,
        useful_flops_ratio=(mflops["total"] / (total * n_dev)
                            if mflops and total else None),
        collectives=colls, collective_wire_bytes=wire, hbm_bytes=hbm,
        roofline=dict(compute_s=compute_s, memory_s=memory_s,
                      collective_s=coll_s, bound=bound, step_s=dom))


def _mesh_tag(multi_pod: bool, mesh_shape=None) -> str:
    if mesh_shape:
        return "mesh" + "x".join(str(n) for n in mesh_shape)
    return MESH_TAGS[multi_pod]


def run_cell(arch_name: str, shape_name: str, multi_pod: bool,
             out_dir: str = OUT, force: bool = False,
             overrides: dict | None = None, tag: str = "", *,
             mesh_shape=None, batch: int | None = None,
             seq: int | None = None) -> dict:
    """One cell's record, read from ``out_dir`` when it is there (and not
    ``force``), else traced and written: ``ok``, ``n/a`` (the reference's
    ``runnable``), ``not_ported`` (the port's refusal) or ``error``."""
    from ..configs import SHAPES, runnable
    mesh_tag = _mesh_tag(multi_pod, mesh_shape) + tag
    arch, shape, _, _ = cell_config(arch_name, shape_name, multi_pod,
                                    overrides, mesh_shape=mesh_shape,
                                    batch=batch, seq=seq)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir,
                        f"{arch_name}__{shape.name}__{mesh_tag}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    rec = {"arch": arch_name, "shape": shape.name, "mesh": mesh_tag}
    ok, reason = ((True, "") if _is_lstm(arch_name) else
                  runnable(arch, SHAPES[shape_name]))
    if not ok:
        rec.update(status="n/a", reason=reason)
    else:
        t0 = time.perf_counter()
        try:
            tr = build_cell(arch_name, shape_name, multi_pod, overrides,
                            mesh_shape=mesh_shape, batch=batch, seq=seq)
            rec.update(_record(tr))
        except NotPorted as e:
            rec.update(status="not_ported", reason=str(e),
                       trace_s=round(time.perf_counter() - t0, 2))
            if hasattr(e, "brds"):
                rec.update(brds=e.brds, packed_params_bytes=e.held,
                           hbm_bytes=e.hbm)
        except Exception as e:   # recorded, as the reference's errors are
            rec.update(status="error", error=f"{type(e).__name__}: {e}",
                       traceback=traceback.format_exc()[-4000:])
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=float)
    return rec


# ----------------------------------------------------------------- main

def _gib(rec) -> float:
    return rec["memory"]["peak_bytes"] / 2**30


def main(argv=None) -> int:
    from ..configs import ARCH_NAMES, SHAPES
    ap = argparse.ArgumentParser(
        description="Trace every (arch × shape) cell as one rank of the "
        "production mesh on fake tensors (see the module docstring).")
    ap.add_argument("--arch", default="all",
                    help="arch name(s), comma-separated, or 'all'")
    ap.add_argument("--shape", default="all",
                    help="shape name(s), comma-separated, or 'all'")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--hlo-dir", default=None,
                    help="refused: the port compiles no HLO")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--layout", default=None, choices=[None, "tp", "dp"])
    ap.add_argument("--brds", action="store_true",
                    help="pack the BRDS row-balanced weights (abstract)")
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache variant")
    ap.add_argument("--tag", default="")
    ap.add_argument("--mesh-shape", default=None,
                    help="DATA,MODEL: a (data, model) mesh in place of "
                    "the production ones")
    ap.add_argument("--batch", type=int, default=None,
                    help="the shape's global batch, changed")
    ap.add_argument("--seq", type=int, default=None,
                    help="the shape's length, changed")
    args = ap.parse_args(argv)
    if args.hlo_dir is not None:
        ap.error("--hlo-dir: the port traces the step on fake tensors and "
                 "compiles no HLO; its records hold what the trace reads")
    mesh_shape = (tuple(int(v) for v in args.mesh_shape.split(","))
                  if args.mesh_shape else None)
    archs = ARCH_NAMES if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = ([False] if mesh_shape else
              {"single": [False], "multi": [True],
               "both": [False, True]}[args.mesh])
    counts = {"ok": 0, "n/a": 0, "not_ported": 0, "error": 0}
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                ov = {}
                if args.layout:
                    ov["layout"] = args.layout
                if args.brds:
                    ov["brds"] = True
                if args.kv_quant:
                    ov["kv_quant"] = True
                rec = run_cell(arch, shape, mp, args.out, args.force,
                               overrides=ov or None, tag=args.tag,
                               mesh_shape=mesh_shape, batch=args.batch,
                               seq=args.seq)
                tag = rec["mesh"]
                status = rec.get("status")
                counts[status] = counts.get(status, 0) + 1
                if status == "ok":
                    r = rec["roofline"]
                    print(f"[OK ] {arch:26s} {rec['shape']:12s} {tag:10s} "
                          f"{_gib(rec):8.2f} GiB/rank "
                          f"fits={rec['memory']['fits']!s:5s} "
                          f"bound={r['bound']:10s} "
                          f"step={r['step_s'] * 1e3:10.3f}ms "
                          f"trace={rec['trace_s']:.1f}s", flush=True)
                elif status == "n/a":
                    print(f"[N/A] {arch:26s} {shape:12s} {tag}: "
                          f"{rec['reason'][:60]}", flush=True)
                elif status == "not_ported":
                    print(f"[NP ] {arch:26s} {shape:12s} {tag}: "
                          f"{rec['reason'][:110]}", flush=True)
                else:
                    print(f"[ERR] {arch:26s} {shape:12s} {tag}: "
                          f"{rec.get('error', '')[:120]}", flush=True)
    print(f"done: {counts['ok']} ok, {counts['n/a']} n/a, "
          f"{counts['not_ported']} not_ported, {counts['error']} errors",
          flush=True)
    return 1 if counts["error"] else 0


if __name__ == "__main__":
    raise SystemExit(main())

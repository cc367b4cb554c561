"""Serving engine: prefill + on-device lockstep batched decode.

``generate`` prefills eagerly and decodes through ``runtime.decode_loop``:
on the card one CUDA graph of every decode step, captured at the first
call of a shape and replayed after it (``spec.spec_decode_loop``'s chunks
of rounds with a draft). The ``engine.*`` spans (``obs.trace``) chart
prepare, prefill and the decode call's host time.

``sparsity=`` is the BRDS seam: ``prepare(params)`` prunes to the policy's
patterns and, for models that decode through packed kernels
(``supports_packed_decode``, the LSTM's dual-ratio datapath), packs the
surviving weights and pads their rows once, so serving runs the BRDS
kernels rather than masked dense matmuls. The policy's temporal-delta and
quant rules rewire the model there too. ``generate(draft=...)`` decodes by
speculative rounds (``repro_torch.spec``).

``mesh=`` (a (data, model) DeviceMesh, ``launch.mesh``) serves the packed
LSTM sharded (``repro_torch.dist``) and every model of the zoo
tensor-parallel and split-KV (``dist.splitkv``: the dense GQA
transformers, the mixture of experts, the encoder-decoder, the VLM, the
int8 KV cache, the recurrent families): every rank runs this engine
on the same inputs; ``prepare`` hands each rank its gate-aligned block of
the packed rows, or its pieces of the model's params, and ``generate``
decodes the rank's data group's rows (and their frames or patches) and
all-gathers the tokens over ``data`` at the end. Under a mesh the decode
loop is the host loop (``runtime.decode_loop_eager``), by choice: a
step's all-gather runs on the host under gloo, which a CUDA graph cannot
capture.
"""
from __future__ import annotations

import torch

from . import runtime
from .sampling import SamplingConfig, sample_dist
from ..device import resolve_device
from ..obs import trace as obs_trace


def cache_shardings(mesh, model, batch: int, max_len: int):
    """The DTensor placements (one a mesh dim) of each leaf of the decode
    cache of ``batch`` rows over ``mesh``, resolved from the leaves'
    logical axes over the whole cache's shapes (the reference's
    ``cache_shardings``). Under a mesh the LSTM's c shards over ``model``
    (``lstm_hidden_shard``) and m with its gate rows, h stays replicated;
    a zoo model's KV cache over ``model`` on ``cache_seq``, RG-LRU's ``h``
    / ``conv`` on ``d_rnn`` and RWKV6's ``S`` on its heads; the batch
    splits over ``data`` where it divides."""
    from ..sharding import placements
    whole = (model.with_mesh(None) if getattr(model, "mesh", None)
             is not None else model)
    shapes = runtime.leaves(whole.cache_defs(batch, max_len))
    defs = model.cache_defs(batch, max_len)
    return runtime.unflatten(defs, [
        placements(mesh, d.axes, w.shape)
        for d, w in zip(runtime.leaves(defs), shapes)])


def _sharded(params) -> bool:
    """Whether ``params`` are DTensor pieces (a sharded init's)."""
    from torch.distributed.tensor import DTensor
    return any(isinstance(x, DTensor) for x in runtime.leaves(params))


class ServeEngine:
    def __init__(self, model, *, max_len: int = 2048, sparsity=None,
                 device=None, spec_rounds: int | None = None, mesh=None):
        """``sparsity``: a SparsityPolicy (or compiled SparsityPlan) applied
        by ``prepare``. ``device`` defaults to ``cuda`` and raises without
        a card unless ``device="cpu"`` is given. ``spec_rounds``: the
        speculative rounds one captured chunk holds, one host read each
        (``spec.ROUNDS_PER_CHUNK``, 4, when None). ``mesh``: a (data,
        model) DeviceMesh to serve the packed LSTM sharded over."""
        if not runtime.conforms(model):
            raise TypeError(
                f"{type(model).__name__} does not implement the serving "
                "contract (cache_defs / init_cache / prefill / decode_step)")
        self.model = model
        self.max_len = max_len
        self.sparsity = sparsity
        self.device = resolve_device(device)
        self.mesh = mesh
        # set by prepare when it partitions the packed params over the
        # mesh (and rewires the model to the sharded step)
        self._dist = False
        if spec_rounds is None:
            from ..spec import ROUNDS_PER_CHUNK as spec_rounds
        self.spec_rounds = spec_rounds
        # the captured decode and spec graphs of this engine's calls
        self.graphs = runtime.GraphCache()

    @obs_trace.traced("engine.prepare")
    def prepare(self, params, calib=None):
        """Prune params to the engine's policy and, when the model decodes
        through packed kernels (``supports_packed_decode``), pack the
        survivors from the prune masks with rows padded to the kernel
        block. Returns (params, report); report is None when the engine is
        dense.

        A policy carrying an activation rule (``DeltaGateConfig``) rewires
        ``self.model`` through ``with_delta``, so the decode cache grows the
        temporal reference state. A ``quant`` rule (``QuantConfig``)
        calibrates activation scales over ``calib`` (a token batch run
        through the dense ``params``, ``calibrate_lstm``; ``default_plan``
        when None), rewires the model through ``with_quant``, and packing
        emits RowBalancedSparseQ8 for the q8 kernels."""
        if self.sparsity is None:
            return self._maybe_partition(params), None
        plan = (self.sparsity.compile(params)
                if hasattr(self.sparsity, "compile") else self.sparsity)
        act = getattr(plan, "activation", None)
        qcfg = getattr(plan, "quant", None)
        if act is not None:
            if not hasattr(self.model, "with_delta"):
                raise ValueError(
                    f"sparsity policy carries an activation rule ({act}) "
                    f"but {type(self.model).__name__} has no temporal-"
                    "delta serving path (with_delta)")
            self.model = self.model.with_delta(act)
        if qcfg is not None:
            if not hasattr(self.model, "with_quant"):
                raise ValueError(
                    f"sparsity policy carries a quant rule ({qcfg}) but "
                    f"{type(self.model).__name__} has no quantized "
                    "serving path (with_quant)")
            from ..quant import calibrate_lstm, default_plan
            if calib is not None:
                qplan = calibrate_lstm(self.model, params,
                                       torch.as_tensor(calib,
                                                       device=self.device),
                                       qcfg)
            else:
                qplan = default_plan(qcfg, len(params["layers"]))
            self.model = self.model.with_quant(qplan)
        if _sharded(params):
            # a sharded init's pieces: each mask from its whole leaf
            from ..training.train_loop import prune_sharded
            pruned, masks, report = prune_sharded(plan, params)
        else:
            pruned, masks = plan.prune(params)
            report = plan.summary(masks)
        if not getattr(self.model, "supports_packed_decode", False):
            return self._maybe_partition(pruned), report
        packed, pack_report = plan.pack(pruned, masks)
        packed = self._maybe_partition(packed)
        if not self._dist and hasattr(self.model, "pad_packed_params"):
            # sharded decode re-splits the rows: no padding there
            packed = self.model.pad_packed_params(packed)
        return packed, {**report, **pack_report}

    def _maybe_partition(self, packed):
        """Each rank's gate-aligned block of the packed rows
        (``dist.partition_lstm_params``), or its pieces of an attention
        model's params (``dist.splitkv``), the model rewired to the
        sharded step. As it is without a mesh, a ``model`` axis or
        partitionable params."""
        from .. import dist
        if self.mesh is None:
            return packed
        from ..dist import splitkv
        if splitkv.supports_splitkv(self.model, self.mesh):
            self.model = self.model.with_mesh(self.mesh)
            self._dist = True
            return splitkv.partition_transformer_params(packed, self.model,
                                                        self.mesh)
        if (not dist.supports_dist(self.model, self.mesh)
                or not dist.is_partitionable(packed)):
            return packed
        packed = dist.partition_lstm_params(packed, self.mesh)
        self.model = self.model.with_mesh(self.mesh)
        self._dist = True
        return packed

    def generate(self, params, tokens, steps: int, *, extra=None,
                 temperature: float = 0.0, top_k: int = 0, eos_id: int = -1,
                 rng: torch.Generator | None = None,
                 sampling: SamplingConfig | None = None,
                 return_state: bool = False, lengths=None, draft=None,
                 spec_k: int = 4):
        """Generate ``steps`` tokens for a lockstep batch of prompts.

        tokens (B, S) prompt ids; ``extra`` the family's conditioning for
        the prefill (an encoder-decoder's frame embeddings, a VLM's patch
        embeddings). Returns (B, steps) int32 ids; finished sequences
        (per-sequence EOS) pad with ``sampling.pad_id``.
        ``return_state=True`` also returns the decode loop's final state.

        ``lengths`` ((B,) ints) serves a ragged batch in one lockstep call:
        ``tokens`` is right-padded to a common width, the length-masked
        prefill keeps each sequence's padding out of its state, and decode
        runs with per-sequence positions.

        ``draft`` (a ``spec.DraftModel``) switches generation to
        speculative rounds: the draft proposes ``spec_k`` tokens, the
        target verifies the block, and both roll back to the accepted
        prefix. Greedy output is token for token that of ``draft=None``;
        ``return_state=True`` then also gives the per-row ``rounds``,
        ``drafted`` and ``accepted`` counters (acceptance rate = accepted
        / drafted).
        """
        if sampling is None:
            sampling = SamplingConfig(temperature=temperature, top_k=top_k,
                                      eos_id=eos_id)
        if rng is None:
            rng = torch.Generator(device=self.device).manual_seed(0)
        tokens = torch.as_tensor(tokens, device=self.device)
        mesh = getattr(self.model, "mesh", None)
        B = tokens.shape[0]
        rows = slice(0, B)
        if mesh is not None:
            rows = self._shard_rows(mesh, self.model, params, B, draft)
            tokens = tokens[rows]
        if lengths is not None:
            if not runtime.prefill_accepts_length(self.model):
                raise TypeError(
                    f"{type(self.model).__name__}.prefill has no "
                    "length-masked path — ragged lockstep serving needs the "
                    "`length` prefill parameter")
            lengths = torch.as_tensor(lengths, dtype=torch.int32,
                                      device=self.device)[rows]
            pos = lengths
        else:
            pos = tokens.shape[1]
        kw = {} if lengths is None else {"length": lengths}
        if extra is not None:
            kw["extra"] = torch.as_tensor(extra, device=self.device)[rows]
        if runtime.prefill_accepts_cache(self.model):
            # built in the decode graphs' static cache: no second copy
            kw["cache"] = self.graphs.static_cache(
                self.model, tokens.shape[0], self.max_len, self.device)
        with obs_trace.span("engine.prefill", batch=tokens.shape[0],
                            width=tokens.shape[1],
                            ragged=lengths is not None):
            logits, cache = self.model.prefill(params, tokens,
                                               max_len=self.max_len, **kw)
        if draft is not None:
            return self._speculate(params, tokens, steps, logits, cache,
                                   rng, sampling, lengths, draft, spec_k,
                                   return_state)
        # the span covers the capture (first call) or the replay's enqueue
        with obs_trace.span("engine.decode_loop", steps=steps):
            if mesh is None:
                toks, state = runtime.decode_loop(
                    self.model, params, cache, logits, pos, rng, steps,
                    sampling, limit=self.max_len, graphs=self.graphs,
                    clone_state=return_state)
            else:
                # the host loop, by choice: gloo's all-gathers run on the
                # host, where a CUDA graph cannot hold them
                toks, state = runtime.decode_loop_eager(
                    self.model, params, cache, logits, pos, rng, steps,
                    sampling, limit=self.max_len)
        if tokens.shape[0] != B:
            toks, state = self._gather_rows(mesh, toks, state)
        return (toks, state) if return_state else toks

    @staticmethod
    def _shard_rows(mesh, model, params, batch: int, draft) -> slice:
        """This rank's rows of a sharded ``generate``'s batch: its data
        group's block where ``data`` divides the batch, else every row.
        Every rank of a ``model`` group decodes them alike (and draws alike
        from a generator in the same state)."""
        from ..dist import check_partitioned
        from ..dist.collective_ops import batch_rows
        if draft is not None:
            raise ValueError("speculative decoding does not compose with "
                             "sharded serving (mesh)")
        # unpartitioned packed params would decode garbage silently
        check_partitioned(params, mesh)
        if hasattr(model, "tp"):          # a split-KV attention model
            from ..dist.splitkv import check_splitkv_partitioned
            check_splitkv_partitioned(params)
        return batch_rows(mesh, batch)

    @staticmethod
    def _gather_rows(mesh, toks, state):
        """The data groups' tokens and per-row state leaves all-gathered
        over ``data``: the whole batch's, as one device would return them.
        The cache stays this rank's shard."""
        from ..dist.collective_ops import gather_axis
        state = {k: (v if k == "cache" or v.ndim == 0
                     else gather_axis(v, mesh, "data", 0))
                 for k, v in state.items()}
        return gather_axis(toks, mesh, "data", 0), state

    def _speculate(self, params, tokens, steps, logits, cache, rng,
                   sampling, lengths, draft, spec_k, return_state):
        """The draft's prefill on the same prompt (ragged with ``length=``),
        then ``spec_decode_loop`` from the target's prefill distribution."""
        from ..spec import spec_decode_loop
        if lengths is not None:
            if not runtime.prefill_accepts_length(draft.model):
                raise TypeError(
                    f"{type(draft.model).__name__}.prefill has no "
                    "length-masked path — ragged speculative serving needs "
                    "the `length` prefill parameter")
            _, dstate = draft.prefill(draft.params, tokens,
                                      max_len=self.max_len, length=lengths)
            pos = lengths
        else:
            _, dstate = draft.prefill(draft.params, tokens,
                                      max_len=self.max_len)
            pos = tokens.shape[1]
        probs = sample_dist(logits[:, -1], sampling)
        with obs_trace.span("engine.spec_loop", steps=steps, k=spec_k):
            toks, state = spec_decode_loop(
                self.model, draft, params, draft.params, cache, dstate,
                probs, pos, rng, steps, spec_k, sampling,
                limit=self.max_len, rounds_per_chunk=self.spec_rounds,
                graphs=self.graphs, clone_state=return_state)
        return (toks, state) if return_state else toks

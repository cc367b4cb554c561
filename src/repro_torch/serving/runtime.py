"""The decode contract servable models implement, and the generation loop
built on it.

A servable model provides ``cache_defs(batch, max_len)``,
``init_cache(batch, max_len, device)``, ``prefill(params, tokens, max_len,
extra=None[, length=None])`` → (last logits (B, 1, V), cache) and
``decode_step(params, cache, tokens, pos)`` → (logits (B, 1, V), cache).

``decode_body`` is one decode step over a carry of static buffers, in
place: sampling, pad emission, the EOS / budget / cache-limit stops, the
model's step and the position bookkeeping, reading nothing back to the
host. ``decode_loop`` runs ``steps`` of them as one ``CapturedLoop``: on
the card a CUDA graph captured once per (kernel backend, model, params,
batch, steps, sampling, limit, position kind) and replayed after that,
the reference's one dispatch a generate; on the CPU the same body,
eagerly.
``decode_loop_eager`` is the host loop it replaced, kept to compare
against: one Python iteration, and the model's launches, a step. It is
also the sharded (mesh) path's loop: under gloo a step's all-gather of h
runs on the host, which a CUDA graph cannot capture, so ``ServeEngine``
and the scheduler choose the host loop from their mesh
(``CapturedLoop(capture=False)``) rather than from a failed capture.

A capture that fails raises; nothing falls back to the host loop.
"""
from __future__ import annotations

import collections
import gc
import inspect
import weakref
from typing import Any, Protocol, runtime_checkable

import torch

from .sampling import SamplingConfig, sample
from ..kernels import _build
from ..sparse.backend import get_default_backend

__all__ = ["DecodeStep", "conforms", "decode_loop", "decode_loop_eager",
           "decode_body", "CapturedLoop", "CountedGraph", "GraphCache",
           "prefill_accepts_length", "prefill_accepts_cache", "leaves",
           "unflatten", "assign", "clone_tree"]


@runtime_checkable
class DecodeStep(Protocol):
    """The decode contract every servable model family implements (the
    reference's ``repro.serving.runtime.DecodeStep``).

    Methods
    -------
    cache_defs(batch, max_len)
        Decode-cache declaration as a ``PSpec`` tree (KV cache, recurrent
        state, the LSTM's (c, h) and its temporal-delta state): whatever
        the family keeps per sequence. Its logical axis names drive the
        scheduler's slot joins and the speculative rollback.
    init_cache(batch, max_len, device)
        A zeroed cache of ``cache_defs``' shapes on ``device``.
    prefill(params, tokens, max_len, extra=None)
        Process a full prompt. Returns (last logits (B, 1, V), cache). A
        family may also take ``length`` ((B,) true prompt lengths: the
        padding after them must not perturb the state) and ``cache`` (a
        cache to build in, in place).
    decode_step(params, cache, tokens, pos)
        Advance one token. ``tokens`` (B, 1); ``pos`` a scalar (lockstep)
        or (B,) int32 positions (continuous batching). Returns (logits
        (B, 1, V), cache).

    Rewind contract: ``pos`` is the source of truth for a sequence's
    length. Positional leaves (a ``cache_seq`` axis: KV caches and an int8
    cache's scales) at positions ≥ ``pos`` are dead, never read and freely
    overwritten, so a caller may rewind by re-issuing a smaller ``pos``
    (an encoder-decoder's cross memory is positional too, and decode only
    reads it). Non-positional
    leaves (recurrent state: the LSTM's (c, h) and delta references,
    RG-LRU's h and conv, RWKV6's S, x_tm and x_cm) fold every token in,
    so a rewinder checkpoints and restores them
    (``spec.verify.rollback``).
    """

    def cache_defs(self, batch: int, max_len: int) -> Any: ...

    def init_cache(self, batch: int, max_len: int, device) -> Any: ...

    def prefill(self, params, tokens, max_len: int, extra=None): ...

    def decode_step(self, params, cache, tokens, pos): ...


def conforms(model) -> bool:
    """Whether ``model`` implements the ``DecodeStep`` serving contract:
    each of its methods is callable on it. Looked up with ``getattr``, so
    a proxy that delegates through ``__getattr__`` conforms too (an
    ``isinstance`` check against the protocol reads attributes
    statically)."""
    return all(callable(getattr(model, m, None))
               for m in ("cache_defs", "init_cache", "prefill", "decode_step"))


def _prefill_accepts(model, name: str) -> bool:
    try:
        return name in inspect.signature(model.prefill).parameters
    except (TypeError, ValueError):
        return False


def prefill_accepts_length(model) -> bool:
    """Whether ``model.prefill`` takes the optional ``length`` argument."""
    return _prefill_accepts(model, "length")


def prefill_accepts_cache(model) -> bool:
    """Whether ``model.prefill`` takes the optional ``cache`` argument, a
    cache to build in place (the transformer's KV cache)."""
    return _prefill_accepts(model, "cache")


# ------------------------------------------------------------------ trees

def leaves(tree) -> list:
    """The leaves of a tree of dicts and lists, dict keys sorted (the
    reference's flatten order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def unflatten(template, flat: list):
    """``template``'s structure with its leaves replaced, in ``leaves``
    order, by ``flat``."""
    return _unflatten(template, iter(flat))


def _unflatten(t, it):
    # a module-level recursion: a recursive closure would form a cycle
    # that keeps the iterator, and every tensor of ``flat``, alive until
    # the garbage collector runs (a KV cache's worth on the card)
    if isinstance(t, dict):
        out = {k: _unflatten(t[k], it) for k in sorted(t)}
        return {k: out[k] for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_unflatten(v, it) for v in t)
    return next(it)


def assign(dst, src) -> None:
    """Copy ``src``'s leaves into ``dst``'s, in place (a leaf that already
    is its destination, as an in-place KV cache's, is left alone)."""
    for d, s in zip(leaves(dst), leaves(src)):
        if s is not d:
            d.copy_(s)


def clone_tree(tree):
    """A copy of a tree of tensors, leaf by leaf."""
    return unflatten(tree, [x.clone() for x in leaves(tree)])


# ---------------------------------------------------------- the loop body

def decode_body(model, params, carry: dict, t: int, generator, sampling:
                SamplingConfig, *, limit: int | None = None) -> None:
    """One decode step over ``carry``'s static buffers, in place.

    ``carry``: ``cache`` (the model's cache tree), ``logits`` (B, 1, V),
    ``pos`` (a 0-d lockstep position or (B,) per-sequence positions,
    int32), ``done`` (B,) bool, ``emitted`` (B,) int32, ``tokens`` (B, T)
    int32 and, optionally, ``budget`` (B,) int32. Samples the next token
    from ``logits``, emits it into column ``t`` of ``tokens`` (``pad_id``
    for a finished sequence), counts it, applies the EOS / budget /
    ``limit`` stops, steps the model and advances ``pos`` (a finished
    sequence's position freezes; a lockstep position once all finish).
    Only ``t`` and the Python constants vary between steps, so a CUDA
    graph of several steps replays them exactly."""
    logits, done, pos, emitted = (carry[k] for k in ("logits", "done", "pos",
                                                     "emitted"))
    budget = carry.get("budget")
    nxt = sample(generator, logits[:, -1], sampling).masked_fill(
        done, sampling.pad_id)
    emitted.add_((~done).to(torch.int32))
    stop = done
    if sampling.stops:
        stop = stop | (nxt == sampling.eos_id)
    if budget is not None:
        stop = stop | (emitted >= budget)
    if limit is not None:
        stop = stop | (pos + 1 >= limit)
    if stop is not done:
        done.copy_(stop)
    new_logits, cache = model.decode_step(params, carry["cache"],
                                          nxt[:, None], pos)
    assign(carry["cache"], cache)
    logits.copy_(new_logits)
    frozen = done if pos.ndim else done.all()
    pos.add_((~frozen).to(torch.int32))
    carry["tokens"][:, t].copy_(nxt)


# ------------------------------------------------------------- the graphs

class CountedGraph:
    """A CUDA graph and the kernel launches its capture recorded.

    The kernel wrappers count a launch in ``_build.LAUNCHES`` when Python
    calls them, and during a capture that issues nothing to the card.
    ``capture`` takes those increments back out and keeps them; every
    ``replay`` adds them again, so the counts keep meaning launches issued
    to the card. ``graph`` is a ``torch.cuda.CUDAGraph`` (or anything with
    ``replay()``); ``capture_ctx(graph)`` the context that captures into it
    (``torch.cuda.graph`` unless given)."""

    def __init__(self, graph, capture_ctx=None):
        self.graph = graph
        self._ctx = capture_ctx if capture_ctx is not None else \
            torch.cuda.graph
        self.launches: dict[str, int] = {}

    def capture(self, fn) -> None:
        before = dict(_build.LAUNCHES)
        # no garbage collection while capturing: a collected graph's
        # teardown is a CUDA call that invalidates the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with self._ctx(self.graph):
                fn()
        finally:
            if collecting:
                gc.enable()
            after = dict(_build.LAUNCHES)
            _build.LAUNCHES.update(before)
        self.launches = {k: n - before.get(k, 0) for k, n in after.items()
                         if n != before.get(k, 0)}

    def replay(self) -> None:
        self.graph.replay()
        for k, n in self.launches.items():
            _build.LAUNCHES[k] += n


class CapturedLoop:
    """``fn(carry)``, which updates a carry of static buffers in place: on
    the card one CUDA graph, captured at the first ``run`` and replayed at
    every ``run``; on the CPU ``fn`` itself, eagerly.

    Before the capture, ``warmup`` (``fn`` when None) runs once on a clone
    of the carry on a side stream, so the first-use work of the kernels
    and libraries (a library's build and load, a table's copy to the card,
    cuBLAS's handle and workspace) happens outside the capture and the
    live buffers stay as they were. ``generator`` (temperature > 0) is the
    generator ``fn`` draws from: on the card it is registered with the
    graph, so every replay draws fresh numbers, the ones the eager body
    would draw from the same state; the warm-up's draws are undone.
    The loop keeps whatever ``keep`` holds alive as long as it lives (the
    objects its graph reads through addresses: params, shared buffers).
    ``capture=False`` runs ``fn`` eagerly on the card too (the sharded
    path, whose collectives run on the host).
    """

    def __init__(self, fn, carry: dict, *, warmup=None, generator=None,
                 keep=(), capture: bool = True):
        self.fn = fn
        self.carry = carry
        self.warmup = warmup
        self.generator = generator
        self.keep = keep
        self.capture = capture
        self.device = leaves(carry)[0].device
        self.graph: CountedGraph | None = None

    def run(self) -> None:
        if self.device.type != "cuda" or not self.capture:
            self.fn(self.carry)
            return
        if self.graph is None:
            self._capture()
        self.graph.replay()

    def _capture(self) -> None:
        cur = torch.cuda.current_stream(self.device)
        scratch = clone_tree(self.carry)
        state = (self.generator.get_state() if self.generator is not None
                 else None)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            (self.warmup or self.fn)(scratch)
        cur.wait_stream(side)
        if state is not None:
            self.generator.set_state(state)
        del scratch
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        counted = CountedGraph(graph)
        counted.capture(lambda: self.fn(self.carry))
        self.graph = counted


class GraphCache:
    """Captured loops by key, least recently used first, at most ``size``
    of them (each graph owns a memory pool), and the static buffers they
    share by role, shape, dtype and device: one KV cache for every graph
    of a batch and length. A buffer lives while a cached loop holds it.
    ``ServeEngine`` owns one, as the reference's engine owns its jitted
    loops."""

    def __init__(self, size: int = 4):
        self.size = size
        self._loops: collections.OrderedDict = collections.OrderedDict()
        self._static: weakref.WeakValueDictionary = \
            weakref.WeakValueDictionary()

    def __len__(self) -> int:
        return len(self._loops)

    def loop(self, key, make) -> CapturedLoop:
        """The loop cached under ``key`` (``make()`` on a miss)."""
        loop = self._loops.pop(key, None)
        if loop is None:
            loop = make()
            while len(self._loops) >= self.size:
                self._loops.popitem(last=False)
        self._loops[key] = loop
        return loop

    def static(self, role: str, shape, dtype, device) -> torch.Tensor:
        """The shared static buffer of ``role``, ``shape``, ``dtype`` and
        ``device`` (contiguous), made on first use."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        key = (role, tuple(shape), dtype, device)
        buf = self._static.get(key)
        if buf is None:
            buf = torch.empty(tuple(shape), dtype=dtype, device=device)
            self._static[key] = buf
        return buf

    def static_like(self, role: str, like: torch.Tensor) -> torch.Tensor:
        """The shared static buffer of ``role`` with ``like``'s shape,
        dtype and device."""
        return self.static(role, like.shape, like.dtype, like.device)

    def static_cache(self, model, batch: int, max_len: int, device):
        """The shared static cache of ``model.cache_defs(batch, max_len)``,
        for a prefill to build in (``prefill(cache=)``): the buffers
        ``static_carry`` gives the loops' ``cache``, so ``decode_loop``
        copies nothing (contents undefined until built)."""
        defs = model.cache_defs(batch, max_len)
        return unflatten(defs, [self.static(f"cache/{i}", d.shape, d.dtype,
                                            device)
                                for i, d in enumerate(leaves(defs))])

    def static_carry(self, role: str, inputs: dict) -> dict:
        """Shared static buffers shaped as ``inputs``, a dict of tensors
        and trees: the ``cache`` tree's leaves shared by every role (the
        decode and the spec graphs), the rest by ``role``."""
        def tree(name, t):
            return unflatten(t, [self.static_like(f"{name}/{i}", x)
                                 for i, x in enumerate(leaves(t))])
        return {k: tree("cache" if k == "cache" else f"{role}/{k}", v)
                for k, v in inputs.items()}


def transplant(src, dst) -> None:
    """Give ``dst`` ``src``'s generator state (None: nothing to do)."""
    if src is not None and dst is not None and src is not dst:
        dst.set_state(src.get_state())


# ------------------------------------------------------------- decode loop

def decode_loop(model, params, cache, logits, pos, generator, steps: int,
                sampling: SamplingConfig, *, done=None, budget=None,
                limit: int | None = None, graphs: GraphCache | None = None,
                clone_state: bool = True):
    """Generate ``steps`` tokens on the device: ``steps`` ``decode_body``
    steps as one ``CapturedLoop``, a CUDA graph on the card, taken from
    ``graphs`` (captured there at a key's first call; without a cache,
    captured for this call alone).

    Parameters
    ----------
    model : a servable model.
    params : dense, pruned or packed params.
    cache : the decode cache from ``prefill``.
    logits : (B, 1, V) last-position logits from prefill.
    pos : scalar next cache position (lockstep) or (B,) per-sequence
        positions (ragged); a finished sequence's position is frozen.
    generator : torch.Generator on the logits' device (temperature > 0);
        it advances as the draws consume it, as in the eager loop.
    steps : tokens to generate.
    sampling : greedy / temperature / top-k / top-p, EOS and pad ids.
    done : optional (B,) bool, sequences that start finished.
    budget : optional (B,) int, per-sequence max tokens to emit.
    limit : optional cache capacity; sequences stop before passing it.
    graphs : the GraphCache of the caller (``ServeEngine`` keeps one).
    clone_state : False hands back the state as the graph's own static
        buffers (on the card), valid until the graph's next run: for a
        caller that drops it, so no copy of the cache is made.

    Returns
    -------
    (tokens (B, steps) int32, state dict with the final cache, logits, pos,
    done and emitted counts), the caller's own tensors (but for
    ``clone_state=False``).
    """
    B = logits.shape[0]
    dev = logits.device
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev)
    done = (torch.zeros((B,), dtype=torch.bool, device=dev) if done is None
            else torch.as_tensor(done, dtype=torch.bool, device=dev))
    if budget is not None:
        budget = torch.as_tensor(budget, dtype=torch.int32, device=dev)
    inputs = dict(cache=cache, logits=logits, pos=pos, done=done,
                  emitted=torch.zeros((B,), dtype=torch.int32, device=dev))
    if budget is not None:
        inputs["budget"] = budget
    if steps == 0:
        return (torch.zeros((B, 0), dtype=torch.int32, device=dev),
                {k: v for k, v in inputs.items() if k != "budget"})
    draws = sampling.temperature > 0.0

    def body(gen, n):
        def fn(c):
            for t in range(n):
                decode_body(model, params, c, t, gen, sampling, limit=limit)
        return fn

    if dev.type != "cuda":
        carry = dict(clone_tree(inputs), tokens=torch.empty(
            (B, steps), dtype=torch.int32, device=dev))
        CapturedLoop(body(generator, steps), carry).run()
        return carry["tokens"], _state(carry)

    graphs = graphs if graphs is not None else GraphCache(1)

    def make():
        carry = dict(graphs.static_carry("decode", inputs),
                     tokens=torch.empty((B, steps), dtype=torch.int32,
                                        device=dev))
        gen = torch.Generator(dev) if draws else None
        return CapturedLoop(body(gen, steps), carry, warmup=body(gen, 1),
                            generator=gen, keep=(model, params))

    key = ("decode", get_default_backend(), id(model), id(params), B, steps,
           sampling, limit, pos.ndim, budget is not None,
           tuple((tuple(x.shape), x.dtype) for x in leaves(inputs)), dev)
    loop = graphs.loop(key, make)
    assign({k: loop.carry[k] for k in inputs}, inputs)
    if draws:
        transplant(generator, loop.generator)
    loop.run()
    if draws:
        transplant(loop.generator, generator)
    state = _state(loop.carry)
    return (loop.carry["tokens"].clone(),
            clone_tree(state) if clone_state else state)


def _state(carry: dict) -> dict:
    return {k: carry[k] for k in ("cache", "logits", "pos", "done",
                                  "emitted")}


def decode_loop_eager(model, params, cache, logits, pos, generator,
                      steps: int, sampling: SamplingConfig, *, done=None,
                      budget=None, limit: int | None = None):
    """``decode_loop`` as a host loop: one Python iteration, and the
    model's launches, a step. The same arguments and results; kept to hold
    the captured loop against."""
    B = logits.shape[0]
    dev = logits.device
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev)
    per_seq_pos = pos.ndim == 1
    done = (torch.zeros((B,), dtype=torch.bool, device=dev) if done is None
            else torch.as_tensor(done, dtype=torch.bool, device=dev))
    emitted = torch.zeros((B,), dtype=torch.int32, device=dev)
    pad = torch.tensor(sampling.pad_id, dtype=torch.int32, device=dev)
    toks = []
    for _ in range(steps):
        nxt = sample(generator, logits[:, -1], sampling)
        nxt = torch.where(done, pad, nxt)
        emitted = emitted + (~done).to(torch.int32)
        if sampling.stops:
            done = done | (nxt == sampling.eos_id)
        if budget is not None:
            done = done | (emitted >= budget)
        if limit is not None:
            done = done | (pos + 1 >= limit)
        logits, cache = model.decode_step(params, cache, nxt[:, None], pos)
        # freeze positions of finished sequences (scalar: once all finish)
        frozen = done if per_seq_pos else done.all()
        pos = pos + (~frozen).to(torch.int32)
        toks.append(nxt)
    out = (torch.stack(toks, dim=1) if toks
           else torch.zeros((B, 0), dtype=torch.int32, device=dev))
    return out, dict(cache=cache, logits=logits, pos=pos, done=done,
                     emitted=emitted)

"""Continuous batching over the serving contract, built for traffic.

The port of the reference's scheduler, around ``repro_torch.traffic``: the
scheduler owns a preallocated pool of decode *slots* over one shared cache
(``traffic.pool.SlotPool``; recurrent O(1) state makes hundreds of slots
cheap), a priority/deadline admission queue with overload shedding
(``traffic.admission.AdmissionQueue``), and a dispatch-ahead chunk
pipeline (``traffic.dispatch.DispatchQueue``):

  submit → admission queue → (slots free?) bucketed/batched prefill →
  join: the prefilled cache rows, last logits, positions, done flags and
  token budgets are copied into the decode chunk's static buffers at the
  slots, in place (``index_copy_`` along each leaf's batch axis) →
  decode: all slots step together, ``chunk`` steps a dispatch, one CUDA
  graph replay on the card (the eager body on the CPU); ``done`` and
  ``budget`` live ON DEVICE and chain across chunks, so chunk N+1 is
  dispatched before chunk N's tokens reach the host →
  harvest: the oldest in-flight chunk's tokens (its own copy, made right
  after its replay) are waited for, stream out through per-token
  callbacks/events, and finished or past-deadline slots are evicted back
  to the pool (their ``done`` set in place).

With ``dispatch_depth`` ≥ 2 (the default) the host enqueues the next
chunk, admissions included, while the device runs the current one. Depth 1
is the synchronous chunk-per-sync baseline; both decode every request
identically under greedy sampling (the device-resident done / budget
vectors freeze finished slots whenever the host notices).

Prefill runs eagerly, once per power-of-two length bucket rather than per
distinct prompt length when the model's prefill takes ``length=``: prompts
are right-padded to the bucket and masked out of the state (exact);
models without it (the transformer zoo, mixture-of-experts included)
prefill at exact length. Same-bucket requests prefill together in one call
(``prefill_batch``). A request's ``extra`` reaches its prefill (an
encoder-decoder's frames, which must have the config's ``enc_len`` rows:
the slots' cross memory has that many).

Under a ``mesh`` (the packed LSTM sharded over ``repro_torch.dist``, or
any model of the zoo tensor-parallel and split-KV over ``dist.splitkv``)
every rank runs this scheduler: the same admissions, prefills and
harvests, from a clock whose readings rank 0 broadcasts
(``launch.mesh.synced_clock``). The slots split over ``data`` where it
divides them, each rank decoding its block; prefills run on every rank
(a batch-1 prefill stays replicated over ``data``; a zoo model's runs
tensor-parallel on every rank of its ``model`` group, each keeping its
segment of the prompt's keys, its slices of the recurrent state and of
an encoder-decoder's cross memory) and each rank joins the rows whose
slots it holds; a chunk's tokens are all-gathered over ``data`` at its
harvest. The chunk runs eagerly: a step's collectives run on the host
under gloo.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from . import runtime
from .sampling import SamplingConfig, sample_dist
from ..device import resolve_device
from ..obs import counters as obs_counters
from ..obs import trace as obs_trace
from ..traffic import (AdmissionQueue, DispatchQueue, QueuedRequest,
                       SlotInfo, SlotPool)

__all__ = ["Request", "Finished", "TokenEvent", "ContinuousBatchingEngine"]


@dataclasses.dataclass
class Request:
    """One request as a caller describes it (``submit`` takes its
    fields): ``prompt`` (1, S) int tokens, ``max_new`` tokens at most,
    ``extra`` family-specific conditioning, an absolute ``deadline`` on
    the engine's clock, and a ``priority`` (higher first)."""
    uid: int
    prompt: Any
    max_new: int
    extra: Any = None
    deadline: float | None = None
    priority: int = 0


@dataclasses.dataclass
class Finished:
    uid: int
    tokens: np.ndarray          # emitted ids, EOS included if hit
    prompt_len: int
    reason: str = "done"        # done | expired | rejected


@dataclasses.dataclass
class TokenEvent:
    """Incremental output: tokens harvested for ``uid`` this chunk."""
    uid: int
    tokens: list
    first: bool                 # True on the request's first emitted tokens


def _bucket(n: int, cap: int) -> int:
    """Next power of two ≥ n, capped at ``cap``."""
    b = 1
    while b < n:
        b <<= 1
    return min(b, cap)


class ContinuousBatchingEngine:
    """Continuous batching for any servable model.

    ``params`` may be dense, pruned or packed: the model's decode_step
    dispatches (the BRDS LSTM runs its fused or chained kernels on packed
    params). ``device`` defaults to ``cuda`` and raises without a card
    unless ``device="cpu"`` is given. ``mesh`` (a (data, model)
    DeviceMesh) serves sharded: ``params`` must then be
    ``repro_torch.dist.partition_lstm_params``' layout, or a zoo model's
    pieces (``dist.splitkv.partition_transformer_params``; a
    ``ServeEngine`` with the mesh prepares either), and ``draft`` and
    ``counters`` are refused.

    Traffic controls (all keyword-only):

    - ``slots``: pool size. Recurrent models keep O(1) state per slot, so
      hundreds are cheap.
    - ``dispatch_depth``: in-flight decode chunks (1 = synchronous
      baseline, 2 = dispatch-ahead double buffering, the default).
    - ``prefill_batch``: same-bucket admissions prefilled per call.
      Keep 1 when serving uncalibrated q8 params (their dynamic max-abs
      fallback reduces over the prefill batch; calibrated plans are exact
      at any batch).
    - ``bucket_prompts``: pad prompts to power-of-two buckets when the
      model's prefill is ``length``-aware.
    - ``max_queue``: bound the admission queue; overload sheds the worst
      waiting request (reason ``"rejected"``).
    - ``clock``: time source for deadlines/admission (default
      ``time.perf_counter``; tests inject virtual clocks).
    - ``on_token``: per-token streaming callback ``(uid, tokens: list[int],
      first: bool)`` invoked at harvest.
    - ``counters``: keep the ``obs.counters`` vector (decode steps, emitted
      tokens, spec acceptance, delta fired-column gauges) beside the chunk
      state, updated in place at the end of every chunk and copied beside
      its tokens; ``counters()`` returns the harvested dict. Off (the
      default) captures exactly the uninstrumented chunk.
    - ``draft``: a ``spec.DraftModel`` switches every decode chunk to
      speculative rounds (``spec_k`` proposals a round, ``chunk`` rounds
      a chunk, the most a chunk of ``chunk`` tokens can take, so no host
      read is needed inside): each slot carries the draft's state beside
      its cache rows, and chunks chain through the carried next-token
      distribution as plain chunks chain through logits. Greedy token
      streams are those of ``draft=None``.
    """

    def __init__(self, model, params, *, slots: int = 4, max_len: int = 256,
                 sampling: SamplingConfig = SamplingConfig(),
                 chunk: int = 8, seed: int = 0, mesh=None,
                 dispatch_depth: int = 2, prefill_batch: int = 1,
                 bucket_prompts: bool = True, max_queue: int | None = None,
                 clock: Callable[[], float] | None = None,
                 on_token: Callable[[int, list, bool], None] | None = None,
                 draft=None, spec_k: int = 4, counters: bool = False,
                 device=None):
        if not runtime.conforms(model):
            raise TypeError(
                f"{type(model).__name__} does not implement the serving "
                "contract (cache_defs / init_cache / prefill / decode_step)")
        if mesh is not None and getattr(model, "mesh", None) is None:
            if not hasattr(model, "with_mesh"):
                raise TypeError(f"{type(model).__name__} has no sharded "
                                "decode path (with_mesh)")
            model = model.with_mesh(mesh)
        mesh = getattr(model, "mesh", None)
        if mesh is not None:
            # the permuted layout is invisible in the tree structure: packed
            # params that were not partitioned would decode garbage silently
            from ..dist import check_partitioned
            check_partitioned(params, mesh)
            if hasattr(model, "tp"):          # a split-KV zoo model
                from ..dist.splitkv import check_splitkv_partitioned
                check_splitkv_partitioned(params)
            if draft is not None:
                raise ValueError("speculative decoding does not compose "
                                 "with sharded serving (mesh)")
            if counters:
                raise ValueError("counters=True is not reduced over a mesh's "
                                 "ranks: serve without counters under a "
                                 "mesh")
            if clock is None:
                from ..launch.mesh import synced_clock
                clock = synced_clock()
        self.mesh = mesh
        # this rank's slots: its data group's block where data divides them
        self._rows = slice(0, slots)
        if mesh is not None:
            from ..dist.collective_ops import batch_rows
            self._rows = batch_rows(mesh, slots)
        self._local = self._rows.stop - self._rows.start
        self.model = model
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.sampling = sampling
        self.chunk = chunk
        self.prefill_batch = max(1, prefill_batch)
        self.bucket_prompts = bucket_prompts
        self.on_token = on_token
        self._clock = clock or time.perf_counter
        self.device = resolve_device(device)
        self.draft = draft
        self.spec_k = spec_k
        # bucketed joint prefill needs BOTH models' length-masked paths
        self._length_aware = runtime.prefill_accepts_length(model) and (
            draft is None or runtime.prefill_accepts_length(draft.model))
        from ..spec import verify as V
        # per-leaf (positional?, batch axis), from the cache's logical axes
        self._flags = V.cache_leaf_flags(model)
        self._batch_axes = self._flags[1]
        if draft is not None:
            self._d_batch_axes = V.cache_leaf_flags(draft.model)[1]
        self._gen = torch.Generator(self.device).manual_seed(seed)

        # ----- the chunk's static state: built at the first join (the
        # logits' width comes from the first prefill), captured at the
        # first dispatch
        self._carry: dict | None = None
        self._loop: runtime.CapturedLoop | None = None

        # ----- host-side traffic machinery
        self.pool = SlotPool(slots)
        self._aq = AdmissionQueue(max_queue)
        self._dq = DispatchQueue(dispatch_depth)
        self._live: dict[int, SlotInfo] = {}    # uid → seated record
        self._collected: dict[int, list[int]] = {}
        self._drops: list[Finished] = []        # shed at submit time
        self._next_uid = 0
        self.steps_dispatched = 0               # chunk dispatches
        # steps the current occupant's cache has accumulated (prefill +
        # chunk decodes), the divisor for per-slot occupancy accounting
        self.slot_steps = np.zeros(slots, np.int64)
        self._counter_names = (obs_counters.counter_names(model)
                               if counters else None)
        self._counters_host: dict | None = None

    # ------------------------------------------------------------- device
    def _to_device(self, a, dtype=torch.int32) -> torch.Tensor:
        """A host array on the device, copied from pinned memory without
        waiting for the stream (the dispatch-ahead must not stall)."""
        t = torch.as_tensor(np.asarray(a), dtype=dtype)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    @property
    def cache(self):
        """The slots' decode cache (the chunk's static buffers)."""
        return None if self._carry is None else self._carry["cache"]

    def _build_carry(self, width: int) -> None:
        S, dev = self._local, self.device
        z = lambda dt: torch.zeros((S,), dtype=dt, device=dev)
        c = dict(cache=self.model.init_cache(S, self.max_len, dev),
                 pos=z(torch.int32), done=torch.ones((S,), dtype=torch.bool,
                                                     device=dev),
                 budget=z(torch.int32), emitted=z(torch.int32),
                 tokens=torch.full((S, self.chunk), self.sampling.pad_id,
                                   dtype=torch.int32, device=dev))
        if self.draft is None:
            c["logits"] = torch.zeros((S, 1, width), dtype=torch.float32,
                                      device=dev)
        else:
            c["dstate"] = self.draft.model.init_cache(S, self.max_len, dev)
            c["probs"] = torch.zeros((S, width), dtype=torch.float32,
                                     device=dev)
            for k in ("rounds", "drafted", "accepted", "rounds_total",
                      "drafted_total", "accepted_total"):
                c[k] = z(torch.int32)
        if self._counter_names is not None:
            c["counters"] = obs_counters.zeros(self._counter_names, dev)
        self._carry = c
        gen = self._gen if self.sampling.temperature > 0.0 else None
        self._loop = runtime.CapturedLoop(self._chunk_fn, c, generator=gen,
                                          keep=(self.params,),
                                          capture=self.mesh is None)

    def _chunk_fn(self, c: dict) -> None:
        """One decode chunk over the static state, in place: ``chunk``
        decode steps (or speculative rounds), then the budget left and the
        counters. Captured as one CUDA graph on the card."""
        c["emitted"].zero_()
        st = {"emitted": c["emitted"], "cache": c["cache"]}
        if self.draft is None:
            for t in range(self.chunk):
                runtime.decode_body(self.model, self.params, c, t, self._gen,
                                    self.sampling, limit=self.max_len)
        else:
            from ..spec import spec_round
            c["tokens"].fill_(self.sampling.pad_id)
            for k in ("rounds", "drafted", "accepted"):
                c[k].zero_()
            for _ in range(self.chunk):
                spec_round(self.model, self.draft, self.params,
                           self.draft.params, c, self.spec_k, self._gen,
                           self.sampling, self._flags, steps=self.chunk,
                           limit=self.max_len)
            for k in ("rounds", "drafted", "accepted"):
                c[f"{k}_total"].add_(c[k])
                st[k] = c[k]
        # budget lives on device so the next chunk can dispatch before
        # this one's tokens reach the host
        c["budget"].sub_(c["emitted"]).clamp_min_(0)
        if self._counter_names is not None:
            obs_counters.chunk_update(self._counter_names, c["counters"], st,
                                      self.chunk)

    def _join(self, pre_cache, pre_logits, pre_dstate, slots_v, lengths_v,
              budgets_v) -> None:
        """Copy a batch of prefill results into the static state at
        ``slots_v`` and arm those slots (done=False, fresh budget)."""
        c = self._carry

        def upd(tree, pre, axes):
            for leaf, p, ax in zip(runtime.leaves(tree),
                                   runtime.leaves(pre), axes):
                if p.shape[:ax] + p.shape[ax + 1:] != \
                        leaf.shape[:ax] + leaf.shape[ax + 1:]:
                    # an encoder-decoder's cross memory: its frames must
                    # have the cache_defs' enc_len rows
                    raise ValueError(
                        f"a prefilled cache leaf of shape {tuple(p.shape)} "
                        f"cannot join the slots' {tuple(leaf.shape)}")
                leaf.index_copy_(ax, slots_v, p.to(leaf.dtype))

        upd(c["cache"], pre_cache, self._batch_axes)
        if self.draft is None:
            c["logits"].index_copy_(0, slots_v,
                                    pre_logits.to(c["logits"].dtype))
        else:
            upd(c["dstate"], pre_dstate, self._d_batch_axes)
            c["probs"].index_copy_(0, slots_v, sample_dist(
                pre_logits[:, -1], self.sampling))
        c["pos"].index_copy_(0, slots_v, lengths_v)
        c["done"].index_fill_(0, slots_v, False)
        c["budget"].index_copy_(0, slots_v, budgets_v)

    # -------------------------------------------------------------- admit
    def submit(self, prompt, max_new: int, extra=None, *,
               deadline: float | None = None, priority: int = 0) -> int:
        """Queue one request. prompt: (S,) or (1, S) int tokens.

        ``deadline`` is an absolute clock() time: past-deadline requests
        are shed from the queue and evicted from slots; ``priority``
        orders admission (higher first). Overload (a full ``max_queue``)
        sheds the worst waiting request with reason ``"rejected"``.
        """
        prompt = np.asarray(torch.as_tensor(prompt).cpu(), np.int32)
        if prompt.ndim == 1:
            prompt = prompt[None, :]
        if prompt.shape[1] >= self.max_len:
            raise ValueError(f"prompt length {prompt.shape[1]} ≥ max_len "
                             f"{self.max_len}")
        uid = self._next_uid
        self._next_uid += 1
        shed = self._aq.push(QueuedRequest(
            uid, prompt, prompt.shape[1], max_new, extra, deadline,
            priority, self._clock()))
        if shed is not None:
            self._drops.append(Finished(shed.uid, np.zeros(0, np.int32),
                                        shed.prompt_len, "rejected"))
        return uid

    @property
    def active_slots(self) -> list[int]:
        return self.pool.active()

    @property
    def _slot_uid(self) -> list[int | None]:
        return self.pool.owners()

    @property
    def pending(self) -> int:
        return len(self._aq)

    @property
    def busy(self) -> bool:
        """Whether step() still has work (queued, decoding, in flight, or
        undelivered shed notices)."""
        return bool(self._aq or self._live or self._dq or self._drops)

    def _admit(self, now: float) -> list[Finished]:
        """Admit queued requests into free slots: expire stale ones, group
        by prefill bucket, prefill (batched where exact), join."""
        events = [Finished(r.uid, np.zeros(0, np.int32), r.prompt_len,
                           "expired") for r in self._aq.expire(now)]
        if not (self.pool.free_count and self._aq):
            return events
        with obs_trace.span("sched.admit", queued=len(self._aq),
                            free=self.pool.free_count):
            while self.pool.free_count and self._aq:
                batch = self._aq.pop(min(self.pool.free_count,
                                         self.prefill_batch))
                for group in self._group(batch):
                    self._prefill_join(group, now)
        return events

    def _group(self, batch: list[QueuedRequest]):
        """Split admitted requests into joint-prefill groups: same padded
        bucket, no extra conditioning. Models without length-aware
        prefill (or with bucketing off) prefill one by one at exact
        length: batching would change their prefill numerics."""
        if not (self._length_aware and self.bucket_prompts):
            return [[r] for r in batch]
        groups: dict[int, list] = {}
        singles: list[list] = []
        for r in batch:
            if r.extra is not None:
                singles.append([r])
            else:
                key = _bucket(r.prompt_len, self.max_len - 1)
                groups.setdefault(key, []).append(r)
        return list(groups.values()) + singles

    def _prefill(self, model, params, group, padded, lengths_v):
        """One prefill call: the bucketed, length-masked one, or the
        exact-length one of the group's single request."""
        if padded is not None:
            return model.prefill(params, padded, max_len=self.max_len,
                                 extra=group[0].extra, length=lengths_v)
        prompt = self._to_device(group[0].prompt, torch.long)
        if group[0].extra is not None:
            return model.prefill(params, prompt, max_len=self.max_len,
                                 extra=group[0].extra)
        return model.prefill(params, prompt, max_len=self.max_len)

    def _prefill_join(self, group: list[QueuedRequest], now: float):
        k = len(group)
        lengths = [r.prompt_len for r in group]
        budgets = [min(r.max_new, self.max_len - r.prompt_len)
                   for r in group]
        slots = self.pool.alloc_many(k)
        assert len(slots) == k      # _admit popped at most free_count
        lengths_v = self._to_device(lengths)
        padded = None
        if self._length_aware and self.bucket_prompts:
            width = _bucket(max(lengths), self.max_len - 1)
            host = np.zeros((k, width), np.int32)
            for i, r in enumerate(group):
                host[i, :r.prompt_len] = r.prompt[0]
            padded = self._to_device(host, torch.long)
        lp, pre_cache = self._prefill(self.model, self.params, group, padded,
                                      lengths_v)
        pre_d = None
        if self.draft is not None:
            _, pre_d = self._prefill(self.draft, self.draft.params, group,
                                     padded, lengths_v)
        if self._carry is None:
            self._build_carry(lp.shape[-1])
        if self.mesh is None:
            self._join(pre_cache, lp, pre_d,
                       self._to_device(slots, torch.long), lengths_v,
                       self._to_device(budgets))
        else:
            self._join_local(pre_cache, lp, slots, lengths, budgets)
        for r, slot, budget in zip(group, slots, budgets):
            info = SlotInfo(r.uid, r.prompt_len, budget, r.deadline,
                            r.priority, admitted_at=now, extra=r.extra)
            self.pool.seat(slot, info)
            self._live[r.uid] = info
            self._collected[r.uid] = []
            self.slot_steps[slot] = r.prompt_len    # join reset the cache

    def _join_local(self, pre_cache, pre_logits, slots, lengths,
                    budgets) -> None:
        """``_join`` of the prefilled rows whose slots this rank holds."""
        lo, hi = self._rows.start, self._rows.stop
        mine = [i for i, s in enumerate(slots) if lo <= s < hi]
        if not mine:
            return
        idx = self._to_device(mine, torch.long)
        pre_cache = runtime.unflatten(pre_cache, [
            leaf.index_select(ax, idx) for leaf, ax in
            zip(runtime.leaves(pre_cache), self._batch_axes)])
        self._join(pre_cache, pre_logits.index_select(0, idx), None,
                   self._to_device([slots[i] - lo for i in mine],
                                   torch.long),
                   self._to_device([lengths[i] for i in mine]),
                   self._to_device([budgets[i] for i in mine]))

    # ------------------------------------------------------------- decode
    def _snapshot(self, t: torch.Tensor) -> torch.Tensor:
        """This chunk's own copy of a static buffer, made right after the
        replay (the next replay overwrites the buffer): pinned host memory
        filled without waiting, on the card; a clone on the CPU."""
        if self.device.type != "cuda":
            return t.clone()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return host.copy_(t, non_blocking=True)

    def _dispatch(self):
        """Enqueue one decode chunk on the chained device state. Returns
        without waiting: the tokens are harvested later."""
        owners = self.pool.owners()
        with obs_trace.span("sched.dispatch", seq=self.steps_dispatched,
                            active=len(self._live)):
            self._loop.run()
            toks = self._snapshot(self._carry["tokens"])
            counters = (self._snapshot(self._carry["counters"])
                        if self._counter_names is not None else None)
            event = None
            if self.device.type == "cuda":
                event = torch.cuda.Event()
                event.record()
            self.steps_dispatched += 1
            # every slot steps through decode_step each chunk (done slots
            # included: lockstep semantics), so all caches advance
            self.slot_steps += self.chunk
            self._dq.push(toks, owners, counters=counters, event=event)

    def _harvest(self, now: float) -> list:
        """Wait for the oldest in-flight chunk's tokens and account them to
        the requests that owned each slot at ITS dispatch time."""
        inflight = self._dq.harvest()
        if inflight is None:
            return []
        with obs_trace.span("sched.harvest", seq=inflight.seq):
            if inflight.event is not None:
                inflight.event.synchronize()        # the one host sync
            toks = inflight.tokens
            if self._local != self.slots:
                from ..dist.collective_ops import gather_axis
                toks = gather_axis(toks, self.mesh, "data", 0)
            toks_np = toks.numpy()
            if inflight.counters is not None:
                self._counters_host = obs_counters.harvest(
                    self._counter_names, inflight.counters)
        events: list = []
        evictions: list[int] = []
        for slot, uid in enumerate(inflight.owners):
            info = self._live.get(uid) if uid is not None else None
            if info is None:        # idle, or finished before this sync
                continue
            fresh: list[int] = []
            for t in toks_np[slot]:
                if info.remaining <= 0:
                    break
                t = int(t)
                fresh.append(t)
                info.remaining -= 1
                info.emitted += 1
                if self.sampling.stops and t == self.sampling.eos_id:
                    info.remaining = 0
            if fresh:
                out = self._collected[uid]
                first = not out
                out.extend(fresh)
                if self.on_token is not None:
                    self.on_token(uid, fresh, first)
                events.append(TokenEvent(uid, fresh, first))
            if info.remaining <= 0:
                events.append(self._finish(uid, "done"))
            elif info.deadline is not None and now > info.deadline:
                # past-deadline occupant: free the slot, freeze it on the
                # device so chunks dispatched from here on skip it
                evictions.append(info.slot)
                events.append(self._finish(uid, "expired"))
        lo, hi = self._rows.start, self._rows.stop
        evictions = [s - lo for s in evictions if lo <= s < hi]
        if evictions:
            with obs_trace.span("sched.evict", slots=len(evictions)):
                self._carry["done"].index_fill_(
                    0, self._to_device(evictions, torch.long), True)
        return events

    def _finish(self, uid: int, reason: str) -> Finished:
        info = self._live.pop(uid)
        self.pool.free(info.slot)
        toks = np.asarray(self._collected.pop(uid), np.int32)
        return Finished(uid, toks, info.prompt_len, reason)

    # -------------------------------------------------------------- drive
    def _step_events(self) -> list:
        """One scheduler iteration: deliver shed notices, admit, keep the
        dispatch pipeline full, harvest the oldest chunk. Returns the
        step's TokenEvent/Finished stream."""
        events: list = self._drops
        self._drops = []
        events += self._admit(self._clock())
        if self._live:
            while self._dq.want_dispatch:
                self._dispatch()
        if self._dq:
            events += self._harvest(self._clock())
        return events

    def step(self) -> list[Finished]:
        """Admit, decode one chunk, harvest, evict. Returns the requests
        that completed (or were shed/expired) this step; per-token output
        flows through ``on_token`` / ``events()``."""
        return [e for e in self._step_events() if isinstance(e, Finished)]

    def events(self):
        """Incremental-results iterator: yields ``TokenEvent``s as chunks
        are harvested and ``Finished`` as requests complete, until the
        engine drains."""
        while self.busy:
            yield from self._step_events()

    def run(self) -> dict[int, np.ndarray]:
        """Drive until queue, slots, and the dispatch pipeline drain.
        Returns {uid: tokens} (shed/expired requests included, with
        whatever prefix they produced)."""
        results: dict[int, np.ndarray] = {}
        for ev in self.events():
            if isinstance(ev, Finished):
                results[ev.uid] = ev.tokens
        return results

    def spec_stats(self) -> dict | None:
        """Cumulative speculative-round accounting (one host sync):
        ``rounds`` / ``drafted`` / ``accepted`` totals plus the aggregate
        ``acceptance_rate`` = accepted / drafted. None without a draft."""
        if self.draft is None:
            return None
        c = self._carry
        tot = {k: (0 if c is None else int(c[f"{k}_total"].sum()))
               for k in ("rounds", "drafted", "accepted")}
        return dict(tot, acceptance_rate=tot["accepted"]
                    / max(tot["drafted"], 1))

    def counters(self) -> dict | None:
        """The harvested on-device counter dict (None when the engine was
        built without ``counters=True``).

        While chunks are in flight this returns the snapshot read at the
        last harvest (no sync). Once the pipeline drains, the vector's
        final value equals the last harvested snapshot."""
        if self._counter_names is None:
            return None
        if self._dq and self._counters_host is not None:
            return dict(self._counters_host)
        if self._carry is None:
            return dict.fromkeys(self._counter_names, 0.0)
        return obs_counters.harvest(self._counter_names,
                                    self._carry["counters"])

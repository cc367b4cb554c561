"""Fault tolerance: a watchdog / retry training loop and straggler
detection, the port of ``repro/training/fault.py``.

  1. ``ResilientLoop.run`` executes steps; on an exception it restores the
     last valid checkpoint (the atomic commit makes it consistent) and
     replays from that step. The data pipeline is a function of (seed,
     step), so the replay sees the same batches.
  2. ``StragglerMonitor`` keeps an EMA of the step time and flags outliers
     (> threshold × EMA); ``on_straggler`` is the hook a deployment uses.
  3. ``elastic_restore`` restores the newest checkpoint re-sharded onto
     a new mesh (scale up or down): a checkpoint holds whole arrays, so
     any mesh reads it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

from .checkpoint import CheckpointManager

__all__ = ["StragglerMonitor", "ResilientLoop", "elastic_restore"]


@dataclasses.dataclass
class StragglerMonitor:
    threshold: float = 2.5        # flag step times > threshold × EMA
    alpha: float = 0.1
    ema: float | None = None
    flagged: int = 0
    history: list = dataclasses.field(default_factory=list)

    def record(self, step_time: float) -> bool:
        is_straggler = (self.ema is not None
                        and step_time > self.threshold * self.ema)
        if is_straggler:
            self.flagged += 1
        else:
            self.ema = (step_time if self.ema is None
                        else (1 - self.alpha) * self.ema
                        + self.alpha * step_time)
        self.history.append((step_time, is_straggler))
        return is_straggler


class ResilientLoop:
    """Checkpoint / restart wrapper around a step function.

    step_fn(state, step) -> state. An exception triggers restore + replay
    (at most ``max_failures`` times). ``clock`` is injectable for tests.
    """

    def __init__(self, ckpt: CheckpointManager, *, save_every: int = 50,
                 max_failures: int = 3,
                 on_straggler: Callable | None = None,
                 straggler: StragglerMonitor | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self.ckpt = ckpt
        self.save_every = save_every
        self.max_failures = max_failures
        self.straggler = straggler or StragglerMonitor()
        self.on_straggler = on_straggler
        self.clock = clock
        self.failures = 0

    def run(self, state, step_fn, start_step: int, num_steps: int):
        step = start_step
        while step < start_step + num_steps:
            t0 = self.clock()
            try:
                state = step_fn(state, step)
            except Exception:
                self.failures += 1
                if self.failures > self.max_failures:
                    raise
                if self.ckpt.latest_step() is None:
                    raise
                state, meta = self.ckpt.restore(state)
                step = meta["step"]
                continue
            if self.straggler.record(self.clock() - t0):
                if self.on_straggler is not None:
                    self.on_straggler(step, self.straggler)
            step += 1
            if step % self.save_every == 0:
                self.ckpt.save(step, state, extra={"data_step": step})
        self.ckpt.wait()
        return state, step


def elastic_restore(ckpt: CheckpointManager, template, new_shardings):
    """Restore the latest checkpoint re-sharded onto a new mesh (elastic
    scale up / down): ``new_shardings`` a tree of ``NamedSharding`` over
    it, matching ``template``. Returns (state, meta)."""
    return ckpt.restore(template, shardings=new_shardings)

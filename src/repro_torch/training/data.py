"""Data pipeline: synthetic corpora with controlled structure + sharded,
restartable loaders. A copy of ``repro/training/data.py`` (numpy only), so
batches are bitwise the reference's.

Datasets are license-gated/offline in this environment (DESIGN.md §7), so we
generate corpora whose statistics make pruning-accuracy ORDERINGS measurable:

- ZipfInduction: Zipf unigram distribution + planted bigram "induction"
  rules (p% of the time token t is followed by rule[t]) — a model must learn
  both marginal stats and associations; pruning damage shows up as
  measurable loss deltas.
- CharCorpus: a small embedded English-like char corpus (PTB stand-in).
- FrameCorpus: synthetic acoustic-frame classification (TIMIT stand-in):
  framewise labels from a random projection + temporal smoothing, so
  recurrent state genuinely helps.

Loaders are deterministic functions of (seed, step) — a restart at step k
reproduces the exact same batch k (fault-tolerance invariant, tested).
Every corpus also exposes ``eval_batches``: held-out batches drawn from a
step namespace offset by ``EVAL_STEP_BASE`` so no training run of any
realistic length can alias the eval stream (the old ``10_000 + i`` offset
collided with training step 10_000).
"""
from __future__ import annotations

import dataclasses

import numpy as np

# Held-out eval batches draw from steps >= this base: far beyond any
# reachable training step count, so train/eval streams never alias.
EVAL_STEP_BASE = 1 << 40


@dataclasses.dataclass
class ZipfInduction:
    vocab_size: int = 512
    alpha: float = 1.2
    rule_frac: float = 0.5      # fraction of steps following a planted rule
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        ranks = np.arange(1, self.vocab_size + 1)
        p = ranks ** (-self.alpha)
        self.probs = p / p.sum()
        self.rules = rng.permutation(self.vocab_size)

    def batch(self, step: int, batch_size: int, seq_len: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        base = rng.choice(self.vocab_size, size=(batch_size, seq_len),
                          p=self.probs)
        use_rule = rng.random((batch_size, seq_len)) < self.rule_frac
        toks = base.copy()
        for t in range(1, seq_len):
            toks[:, t] = np.where(use_rule[:, t],
                                  self.rules[toks[:, t - 1]], base[:, t])
        toks = toks.astype(np.int32)
        return {"tokens": toks, "labels": toks}

    def eval_batches(self, n: int, batch_size: int, seq_len: int):
        return [self.batch(EVAL_STEP_BASE + i, batch_size, seq_len)
                for i in range(n)]


_CHAR_TEXT = (
    "the quick brown fox jumps over the lazy dog . "
    "a journey of a thousand miles begins with a single step . "
    "to be or not to be that is the question . "
    "all that glitters is not gold . actions speak louder than words . "
    "the early bird catches the worm . practice makes perfect . "
    "knowledge is power . time and tide wait for no man . "
    "a picture is worth a thousand words . better late than never . "
) * 50


@dataclasses.dataclass
class CharCorpus:
    seed: int = 0

    def __post_init__(self):
        chars = sorted(set(_CHAR_TEXT))
        self.stoi = {c: i for i, c in enumerate(chars)}
        self.vocab_size = len(chars)
        self.data = np.array([self.stoi[c] for c in _CHAR_TEXT], np.int32)

    def batch(self, step: int, batch_size: int, seq_len: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        starts = rng.integers(0, len(self.data) - seq_len - 1, batch_size)
        toks = np.stack([self.data[s:s + seq_len] for s in starts])
        return {"tokens": toks, "labels": toks}

    def eval_batches(self, n: int, batch_size: int, seq_len: int):
        return [self.batch(EVAL_STEP_BASE + i, batch_size, seq_len)
                for i in range(n)]


@dataclasses.dataclass
class FrameCorpus:
    """Synthetic framewise classification (TIMIT stand-in)."""
    input_size: int = 153
    num_classes: int = 61
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.proj = rng.normal(size=(self.input_size, self.num_classes)) * 0.5

    def batch(self, step: int, batch_size: int, seq_len: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        x = rng.normal(size=(batch_size, seq_len, self.input_size))
        # temporal smoothing → recurrent state helps
        for t in range(1, seq_len):
            x[:, t] = 0.7 * x[:, t - 1] + 0.3 * x[:, t]
        scores = x @ self.proj
        labels = scores.argmax(-1).astype(np.int32)
        return {"inputs": x.astype(np.float32), "labels": labels}

    def eval_batches(self, n: int, batch_size: int, seq_len: int):
        return [self.batch(EVAL_STEP_BASE + i, batch_size, seq_len)
                for i in range(n)]


@dataclasses.dataclass
class ShardedLoader:
    """Deterministic, restartable loader that yields this process's shard of
    the global batch. On a real multi-host deployment each process passes its
    own (shard_idx, num_shards); resharding after an elastic event is just a
    change of those numbers — determinism in (seed, step) keeps every host
    consistent.
    """
    dataset: object
    global_batch: int
    seq_len: int
    shard_idx: int = 0
    num_shards: int = 1

    def batch(self, step: int) -> dict:
        full = self.dataset.batch(step, self.global_batch, self.seq_len)
        per = self.global_batch // self.num_shards
        lo = self.shard_idx * per
        return {k: v[lo:lo + per] for k, v in full.items()}

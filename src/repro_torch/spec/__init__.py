"""Speculative decoding with BRDS-packed recurrent drafts.

A small packed recurrent model (the paper's LSTM) proposes k tokens per
round, the target scores all k+1 positions, an acceptance rule keeps a
prefix, and both models roll back to it by checkpoint/restore of their
recurrent state (the target's positional leaves, where it has any, by
position rewind).

- draft   — DraftModel adapter: proposal chain and state checkpoints
- verify  — k-token target verify and cache rollback
- accept  — greedy exact-match and rejection-sampling acceptance rules
- loop    — the speculate → verify → accept round, and chunks of rounds
            captured as one CUDA graph

Greedy speculative decode is lossless: token for token the target-only
greedy decode.
"""
from .accept import (accept_length, greedy_accept, rejection_accept,
                     residual_dist)
from .draft import DraftModel
from .loop import ROUNDS_PER_CHUNK, spec_decode_loop, spec_round
from .verify import cache_leaf_flags, rollback, state_leaves, verify_chain

__all__ = ["DraftModel", "spec_decode_loop", "spec_round",
           "ROUNDS_PER_CHUNK", "verify_chain", "rollback",
           "state_leaves", "cache_leaf_flags", "greedy_accept",
           "rejection_accept", "residual_dist", "accept_length"]

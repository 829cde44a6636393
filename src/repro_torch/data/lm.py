"""Deterministic synthetic LM token streams (twin of repro.data.lm).

`MarkovStream` is plain numpy in both packages, so the same seed gives the
same tokens here as in the JAX package: an order-2 Markov chain over the
vocab with a seeded random transition table.  The serving launcher draws its
prompts from it.  `lm_batches` (training batches) waits for the training
slice (ROADMAP A16).
"""
from __future__ import annotations

import numpy as np

__all__ = ["MarkovStream"]


class MarkovStream:
    def __init__(self, vocab: int, seed: int = 0, branch: int = 8):
        rng = np.random.default_rng(seed)
        self.vocab = vocab
        # each (prev2, prev1) context allows `branch` likely successors
        self.succ = rng.integers(0, vocab, size=(vocab, branch)).astype(np.int32)
        self.mix = rng.integers(0, vocab, size=(vocab, branch)).astype(np.int32)

    def sample(self, rng: np.random.Generator, batch: int, seq: int) -> np.ndarray:
        out = np.empty((batch, seq + 1), dtype=np.int32)
        out[:, 0] = rng.integers(0, self.vocab, size=batch)
        out[:, 1] = rng.integers(0, self.vocab, size=batch)
        for t in range(2, seq + 1):
            b = rng.integers(0, self.succ.shape[1], size=batch)
            ctx = (out[:, t - 1] + self.mix[out[:, t - 2], b]) % self.vocab
            out[:, t] = self.succ[ctx, b]
        return out

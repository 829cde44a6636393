"""Deterministic synthetic LM token streams (twin of repro.data.lm).

`MarkovStream` is plain numpy in both packages, so the same seed gives the
same tokens here as in the JAX package: an order-2 Markov chain over the
vocab with a seeded random transition table.  The serving launcher draws its
prompts from it, and `lm_batches` the training batches: the JAX package's
tokens, as int64 tensors (the dtype `embedding` and `gather` index with; the
JAX package yields int32) on the caller's device.  The vlm and enc-dec
batches (vision embeddings, audio frames) wait for their slices of ROADMAP
A16 and raise NotPortedError.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

__all__ = ["MarkovStream", "lm_batches"]


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


_UNPORTED_BATCHES = {"vlm": "A16(e)", "encdec": "A16(d)"}


def lm_batches(model, seq: int, batch: int, seed: int = 0, data_vocab: int = 0,
               device="cuda") -> Iterator[dict]:
    """Training batches {"tokens", "labels"} (B, seq) int64 for `model`, on
    `device` (the card unless asked otherwise): the JAX package's draws from
    the same seed, token for token.

    `data_vocab` caps the token ids actually emitted (0 = full vocab), as in
    the JAX twin."""
    # imported here: repro_torch.api imports this package (agents -> data)
    from repro_torch.api.runner import resolve_device
    from repro_torch.core.icoa import NotPortedError

    cfg = model.cfg
    if cfg.family in _UNPORTED_BATCHES:
        raise NotPortedError(
            f"{cfg.arch_id}: {cfg.family} training batches wait for ROADMAP "
            f"{_UNPORTED_BATCHES[cfg.family]}")
    dev = resolve_device(device, "repro_torch.data.lm.lm_batches")
    stream = MarkovStream(min(data_vocab, cfg.vocab_size) if data_vocab
                          else cfg.vocab_size, seed=seed)
    rng = np.random.default_rng(seed + 1)
    while True:
        toks = torch.from_numpy(stream.sample(rng, batch, seq)).to(
            device=dev, dtype=torch.int64)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

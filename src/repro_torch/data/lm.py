"""Deterministic synthetic LM token streams (twin of repro.data.lm).

`MarkovStream` is plain numpy in both packages, so the same seed gives the
same tokens here as in the JAX package: an order-2 Markov chain over the
vocab with a seeded random transition table.  The serving launcher draws its
prompts from it, and `lm_batches` the training batches: the JAX package's
tokens, as int64 tensors (the dtype `embedding` and `gather` index with; the
JAX package yields int32) on the caller's device; the vlm batches' vision
embeddings and the enc-dec batches' audio frames are its float32 normal
draws (a numpy generator seeded with seed + 2) cast to the compute dtype,
and the vlm M-RoPE position ids 0..seq-1 on all three streams, int64.
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


def lm_batches(model, seq: int, batch: int, seed: int = 0, data_vocab: int = 0,
               device="cuda") -> Iterator[dict]:
    """Training batches for `model` on `device` (the card unless asked
    otherwise): {"tokens", "labels"} (B, seq) int64, with "frames" (B,
    n_frames, D) for encdec; for vlm the text is seq less the vision tokens,
    beside "vision_embeds" (B, v, D) and "pos_ids" (3, B, seq).  The JAX
    package's draws from the same seed, token for token and bit for bit.

    `data_vocab` caps the token ids actually emitted (0 = full vocab), as in
    the JAX twin."""
    # imported here: repro_torch.api imports this package (agents -> data)
    from repro_torch.api.runner import resolve_device

    cfg = model.cfg
    dev = resolve_device(device, "repro_torch.data.lm.lm_batches")
    stream = MarkovStream(min(data_vocab, cfg.vocab_size) if data_vocab
                          else cfg.vocab_size, seed=seed)
    rng = np.random.default_rng(seed + 1)
    emb_rng = np.random.default_rng(seed + 2)

    def tensor(a: np.ndarray, dtype) -> torch.Tensor:
        return torch.from_numpy(a).to(device=dev, dtype=dtype)

    def normal(*shape) -> torch.Tensor:
        return tensor(emb_rng.standard_normal(shape, dtype=np.float32), cfg.cdtype())

    while True:
        if cfg.family == "vlm":
            v = cfg.n_vision_tokens
            toks = tensor(stream.sample(rng, batch, seq - v), torch.int64)
            yield {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                   "vision_embeds": normal(batch, v, cfg.d_model),
                   "pos_ids": torch.arange(seq, dtype=torch.int64, device=dev).expand(
                       3, batch, seq).contiguous()}
        elif cfg.family == "encdec":
            frames = normal(batch, cfg.n_frames, cfg.d_model)
            toks = tensor(stream.sample(rng, batch, seq), torch.int64)
            yield {"frames": frames, "tokens": toks[:, :-1], "labels": toks[:, 1:]}
        else:
            toks = tensor(stream.sample(rng, batch, seq), torch.int64)
            yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

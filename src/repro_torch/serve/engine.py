"""Batched serving engine (twin of repro.serve.engine): prefill, then
iterative decode over the KV/state cache.

Sampling is greedy, or by temperature from an explicit torch.Generator
(which cannot reproduce jax.random.categorical's draws: the tests compare
greedy decoding with the JAX package).  The decode loop keeps everything on
the device: the fill position is a host int, and no step waits for the card.

As in the JAX engine, decode step i writes at position s0 + i, s0 the
prompt's text tokens, and a vlm step's M-RoPE position ids are all s0 + i.
The vlm prefill's cache holds the vision prefix before the text, so these
steps overwrite the prompt's text slots from s0 on and attend to positions
<= s0 + i (ROADMAP C9, a fault of the reference that the port keeps for
parity).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

__all__ = ["ServeEngine", "greedy_sample"]


def greedy_sample(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
                  temperature: float = 0.0) -> torch.Tensor:
    if temperature and generator is not None:
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.argmax(logits, dim=-1)


@dataclasses.dataclass
class ServeEngine:
    model: Any
    temperature: float = 0.0

    def generate(self, params, prompt_batch: dict, max_new_tokens: int,
                 generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, Any]:
        """prompt_batch: the model's prompt (tokens (B, S), and the frames,
        or the vision embeddings and pos_ids) on the params' device.

        Returns (generated tokens (B, max_new_tokens), final cache).  The
        prefill cache is padded along the sequence axis to S +
        max_new_tokens before the decode loop."""
        logits, cache = self.model.prefill(params, prompt_batch)
        s0 = prompt_batch["tokens"].shape[1]
        cache = _pad_cache(cache, s0 + max_new_tokens)
        vlm = self.model.cfg.family == "vlm"
        toks = []
        tok = greedy_sample(logits, generator, self.temperature)[:, None]
        for i in range(max_new_tokens):
            toks.append(tok)
            batch = {"tokens": tok, "idx": s0 + i}
            if vlm:
                batch["pos_ids"] = torch.full((3, tok.shape[0], 1), s0 + i,
                                              dtype=torch.int64, device=tok.device)
            logits, cache = self.model.decode_step(params, batch, cache)
            tok = greedy_sample(logits, generator, self.temperature)[:, None]
        return torch.cat(toks, dim=1), cache


def _pad_cache(cache, target_len: int):
    """Grow attention K/V caches (B, S, Hkv, dh) along S to target_len, as
    fresh contiguous tensors (the enc-dec decoder's self_k / self_v too, never
    its cross caches); other entries pass through."""

    def one(name, leaf):
        if (name in ("k", "v", "self_k", "self_v") and leaf.dim() == 4
                and leaf.shape[1] < target_len):
            out = leaf.new_zeros((leaf.shape[0], target_len, *leaf.shape[2:]))
            out[:, : leaf.shape[1]] = leaf
            return out
        return leaf

    return [{name: one(name, leaf) for name, leaf in layer.items()} for layer in cache]

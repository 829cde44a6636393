"""Plain PyTorch version of the flash-decode kernel (twin of
repro.kernels.flash_decode.ref): one-token GQA attention over a filled
cache, fp32 softmax.  The CPU path of kernels.flash_decode.ops and the
yardstick the CUDA kernel is held against on the card."""
from __future__ import annotations

import torch

__all__ = ["decode_ref"]


def decode_ref(q, k, v, idx, *, window: int = 0) -> torch.Tensor:
    """q: (B,Hq,dh); k,v: (B,S,Hkv,dh); positions 0..idx valid (inclusive —
    the new token's K/V is already written at `idx`). fp32 softmax."""
    b, hq, dh = q.shape
    _, s, hkv, _ = k.shape
    g = hq // hkv
    qg = q.reshape(b, hkv, g, dh)
    scores = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k.float()) * (dh ** -0.5)
    pos = torch.arange(s, dtype=torch.int64, device=q.device)
    mask = pos <= idx
    if window > 0:
        mask &= pos > idx - window
    scores = scores.masked_fill(~mask[None, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", probs, v.float())
    return out.reshape(b, hq, dh).to(q.dtype)

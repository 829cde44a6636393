"""Plain PyTorch version of the flash-attention kernel (twin of
repro.kernels.flash_attention.ref): eager GQA attention, causal and/or
sliding-window, fp32 softmax.  The CPU path of kernels.flash_attention.ops
and the yardstick the CUDA kernel is held against on the card."""
from __future__ import annotations

import torch

__all__ = ["attention_ref"]


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B,Sq,Hq,dh); k,v: (B,Skv,Hkv,dh); Hq % Hkv == 0. fp32 softmax."""
    b, sq, hq, dh = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * (dh ** -0.5)
    q_pos = torch.arange(sq, dtype=torch.int64, device=q.device)
    kv_pos = torch.arange(skv, dtype=torch.int64, device=q.device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kv_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= kv_pos[None, :] > q_pos[:, None] - window
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, sq, hq, dh).to(q.dtype)

"""Plain PyTorch versions of the flash-attention kernels.

`attention_ref` is the twin of repro.kernels.flash_attention.ref: eager GQA
attention, causal and/or sliding-window, fp32 softmax.  `attention_lse_ref`
also returns each row's log-sum-exp, which the forward kernel writes when
training, and `attention_bwd_ref` is the closed-form gradient the backward
kernel computes (the JAX package has no backward kernel; its training
differentiates the plain attention, and tests hold this against jax.grad of
attention_ref).  These are the CPU paths of kernels.flash_attention.ops and
the yardsticks the CUDA kernels are held against on the card."""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["attention_ref", "attention_lse_ref", "attention_bwd_ref"]


def _mask(sq: int, skv: int, causal: bool, window: int, device) -> torch.Tensor:
    """(Sq, Skv) True where query row i may see key j."""
    q_pos = torch.arange(sq, dtype=torch.int64, device=device)
    kv_pos = torch.arange(skv, dtype=torch.int64, device=device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kv_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= kv_pos[None, :] > q_pos[:, None] - window
    return mask


def _attend(q, k, v, causal: bool, window: int):
    """(the output (B,Sq,Hq,dh) in q's dtype, the scaled masked fp32 scores
    (B,Hkv,G,Sq,Skv))."""
    b, sq, hq, dh = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * (dh ** -0.5)
    scores = scores.masked_fill(~_mask(sq, skv, causal, window, q.device), float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, sq, hq, dh).to(q.dtype), scores


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B,Sq,Hq,dh); k,v: (B,Skv,Hkv,dh); Hq % Hkv == 0. fp32 softmax."""
    return _attend(q, k, v, causal, window)[0]


def attention_lse_ref(q, k, v, *, causal: bool = True,
                      window: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(attention_ref's output, the same bits, and L (B, Hq, Sq) fp32: L_i
    the natural log-sum-exp of row i's scaled, masked scores)."""
    out, scores = _attend(q, k, v, causal, window)
    b, sq, hq, _ = q.shape
    return out, torch.logsumexp(scores, dim=-1).reshape(b, hq, sq)


def attention_bwd_ref(q, k, v, o, do, lse, *, causal: bool = True,
                      window: int = 0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of attention_ref at (q, k, v) against the output's
    gradient do, from the forward's output o and L (B, Hq, Sq), in closed
    form (not autograd): in fp32,
        P = exp(scale q k^T - L) (0 where masked), D_i = do_i . o_i,
        dS = P (do v^T - D), dv = P^T do, dq = scale dS k, dk = scale dS^T q,
    dk and dv summed over each KV head's query heads -> (dq, dk, dv) in the
    inputs' dtype."""
    b, sq, hq, dh = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    scale = dh ** -0.5
    qg = q.reshape(b, sq, hkv, g, dh).float()
    dog = do.reshape(b, sq, hkv, g, dh).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    mask = _mask(sq, skv, causal, window, q.device)
    p = torch.where(mask, torch.exp(scores - lse.reshape(b, hkv, g, sq)[..., None]), 0.0)
    delta = (dog * o.reshape(b, sq, hkv, g, dh).float()).sum(-1).permute(0, 2, 3, 1)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg) * scale
    return (dq.reshape(b, sq, hq, dh).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))

"""Plain PyTorch versions of the WKV kernel (fp32 contract).

`wkv_ref` is the twin of repro.kernels.wkv.ref.wkv_ref, the sequential
RWKV-6 recurrence, and also returns the final state (B, H, dh, dh), which
the CUDA kernel writes too.  `wkv_chunked_ref` is the twin of the JAX
package's chunked linear-attention form (repro.models.rwkv._wkv_chunked),
which that model takes for configs with rwkv_chunk > 0; like its twin it
divides by the within-chunk cumulative decay, whose exp(-log P) overflows
fp32 once a chunk's summed log-decay passes about -88.  The port runs the
exact recurrence for every config (`wkv_ref` is the CPU path of
kernels.wkv.ops and the yardstick of the kernel on the card); the chunked
twin holds the port's recurrence to the JAX model's chunked form.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["wkv_ref", "wkv_chunked_ref"]


def wkv_ref(r, k, v, w, u) -> Tuple[torch.Tensor, torch.Tensor]:
    """r,k,v,w: (B,S,H,dh) fp32 (w in (0,1)); u: (H,dh) ->
    (out (B,S,H,dh), final state (B,H,dh,dh)).

        out_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
        S_t   = diag(w_t) S_{t-1} + k_t v_t^T
    """
    b, s, h, dh = r.shape
    state = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=r.device)
    outs = []
    for t in range(s):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]
        kv = kt[..., :, None] * vt[..., None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", rt, state + u[None, :, :, None] * kv))
        state = wt[..., :, None] * state + kv
    out = torch.stack(outs, dim=1) if outs else torch.zeros_like(r)
    return out, state


def wkv_chunked_ref(r, k, v, w, u, c: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV: r/k/v/w (B,S,H,dh) fp32, u (H,dh), S % c == 0 ->
    (out (B,S,H,dh), final state (B,H,dh,dh)); the same function as
    `wkv_ref` in another summation order."""
    b, s, h, dh = r.shape
    n = s // c
    state = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=r.device)
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device), diagonal=-1)
    outs = []
    for i in range(n):
        sl = slice(i * c, (i + 1) * c)
        rch, kch, vch, wch = r[:, sl], k[:, sl], v[:, sl], w[:, sl]   # (B,C,H,dh)
        logw = torch.log(torch.clamp(wch, min=1e-38))
        lp = torch.cumsum(logw, dim=1)                               # log P_t (inclusive)
        lp_prev = lp - logw                                          # log P_{t-1}
        r_t = rch * torch.exp(lp_prev)                               # r_t * P_{t-1}
        k_s = kch * torch.exp(-lp)                                   # k_s / P_s
        scores = torch.einsum("bthd,bshd->bhts", r_t, k_s)           # (B,H,C,C)
        scores = torch.where(mask[None, None], scores, 0.0)
        out = torch.einsum("bhts,bshd->bthd", scores, vch)           # (B,C,H,dh)
        bonus = torch.einsum("bthd,bthd->bth", rch * u[None, None], kch)
        out = out + bonus[..., None] * vch
        out = out + torch.einsum("bthk,bhkv->bthv", r_t, state)
        lp_end = lp[:, -1:]                                          # (B,1,H,dh)
        k_end = kch * torch.exp(lp_end - lp)                         # k_s * P_C/P_s
        state = (torch.exp(lp_end[:, 0])[..., None] * state
                 + torch.einsum("bshk,bshv->bhkv", k_end, vch))
        outs.append(out)
    return torch.cat(outs, dim=1), state

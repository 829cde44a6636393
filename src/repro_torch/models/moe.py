"""Mixture-of-Experts FFN (twin of repro.models.moe): a top-k router and
capacity-based dense dispatch.

Dispatch and combine are one-hot einsums over groups of `moe_group_size`
tokens, as in the JAX package: no data-dependent shapes, capacity per group
C = ceil(g * top_k * capacity_factor / E), slots claimed k-major (every
token's first choice before any second choice), a token past its expert's
capacity dropped.  At one token (decode), or at most top_k tokens, every
expert runs densely and the outputs are mixed by the renormalised top-k
weights, with aux = 0.

Parity points with the JAX package:
  * top-k is a stable descending sort, so ties go to the lower expert index
    as in jax.lax.top_k (torch.topk promises no order among ties);
  * an overflowing slot gets a zero one-hot row (the JAX package's
    one_hot(cap, cap)), from the comparison with arange(cap);
  * the combine tensor is fp32 (fp32 routing weights times the compute-dtype
    one-hots promote, as in JAX), the dispatch one-hot `combine > 0` is in
    the compute dtype, and the combine einsum runs in fp32 before the cast
    back to x's dtype;
  * the router runs in fp32.
The expert products are plain batched matmuls (the JAX package computes
them outside Pallas); its sharding constraints are the identity on one
device.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

__all__ = ["moe_init", "moe_apply"]


def moe_init(gen: torch.Generator, cfg) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = cfg.pdtype()
    return {
        "router": L.dense_init(gen, (d, e), torch.float32),    # router kept fp32
        "wi_gate": L.dense_init(gen, (e, d, f), dt),
        "wi_up": L.dense_init(gen, (e, d, f), dt),
        "wo": L.dense_init(gen, (e, f, d), dt),
    }


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of the last axis and their indices, ties to the
    lower index (jax.lax.top_k's order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _aux_losses(logits, probs, expert_mask, cfg) -> torch.Tensor:
    """Switch-style load-balance loss + router z-loss (both fp32 scalars)."""
    lead = tuple(range(expert_mask.dim() - 1))
    density = torch.mean(expert_mask.float(), dim=lead)
    density_proxy = torch.mean(probs, dim=tuple(range(probs.dim() - 1)))
    lb = cfg.n_experts * torch.sum(density * density_proxy)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return cfg.router_aux_weight * lb + cfg.router_z_weight * z


def _expert_ffn(p, xe: torch.Tensor, cfg) -> torch.Tensor:
    """xe: (E, T, D) -> (E, T, D); a SwiGLU per expert."""
    dt = cfg.cdtype()
    gate = torch.bmm(xe, p["wi_gate"].to(dt))
    up = torch.bmm(xe, p["wi_up"].to(dt))
    return torch.bmm(F.silu(gate) * up, p["wo"].to(dt))


def moe_apply(p: dict, x: torch.Tensor, cfg, *,
              decode: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out, aux_loss). x: (B, S, D)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cdt = cfg.cdtype()
    logits = x.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)

    if decode or s <= k:
        # dense path: every expert, mixed by the renormalised top-k weights
        topw, topi = top_k(probs, k)                                  # (B,S,k)
        gate = torch.sum(F.one_hot(topi, e).to(probs.dtype) * topw[..., None], dim=2)
        gate = gate / torch.clamp_min(torch.sum(gate, dim=-1, keepdim=True), 1e-9)
        xe = x.to(cdt).reshape(1, b * s, d).expand(e, b * s, d)
        ye = _expert_ffn(p, xe, cfg).reshape(e, b, s, d)
        out = torch.einsum("ebsd,bse->bsd", ye, gate.to(cdt))
        return out.to(x.dtype), torch.zeros((), dtype=torch.float32, device=x.device)

    g = min(cfg.moe_group_size, s)
    if s % g:
        raise ValueError(f"{s} tokens do not split into MoE groups of "
                         f"moe_group_size={cfg.moe_group_size}")
    ng = s // g
    cap = int(-(-g * k * cfg.capacity_factor // e))
    combine, topi = _slots(probs, cfg, b, ng, g, cap)
    dispatch = (combine > 0).to(cdt)
    aux = _aux_losses(logits, probs, F.one_hot(topi, e).sum(dim=-2) > 0, cfg)

    xe = _dispatch(dispatch, x.reshape(b, ng, g, d).to(cdt))          # (E,B,NG,C,D)
    ye = _expert_ffn(p, xe.reshape(e, b * ng * cap, d), cfg).reshape(e, b, ng, cap, d)
    return _combine(combine, ye).reshape(b, s, d).to(x.dtype), aux


def _slots(probs: torch.Tensor, cfg, b: int, ng: int, g: int,
           cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fp32 combine weights (B, NG, g, E, C) of every token's top-k
    experts and their slots, and the experts (B, NG, g, k).  Slots are
    claimed k-major (all first choices before any second choice), in token
    order within a group; a slot past capacity has a zero one-hot row: the
    token is dropped from that expert."""
    e, k = cfg.n_experts, cfg.top_k
    cdt = cfg.cdtype()
    topw, topi = top_k(probs, k)                                      # (B,S,k)
    topw = topw / torch.clamp_min(torch.sum(topw, dim=-1, keepdim=True), 1e-9)
    topw = topw.reshape(b, ng, g, k)
    topi = topi.reshape(b, ng, g, k)
    slots = torch.arange(cap, dtype=torch.int64, device=probs.device)
    combine = torch.zeros((b, ng, g, e, cap), dtype=torch.float32, device=probs.device)
    counts = torch.zeros((b, ng, e), dtype=torch.int64, device=probs.device)
    for kk in range(k):
        e_idx = topi[..., kk]                                         # (B,NG,g)
        mask_e = F.one_hot(e_idx, e)                                  # (B,NG,g,E)
        cnt = torch.cumsum(mask_e, dim=2)                             # inclusive
        pos = torch.gather(cnt, -1, e_idx[..., None])[..., 0] - 1
        pos = pos + torch.gather(counts, -1, e_idx)                   # after earlier rounds
        oh_c = (pos[..., None] == slots).to(cdt)                      # (B,NG,g,C)
        oh_e = mask_e.to(cdt)
        combine = combine + (topw[..., kk][..., None, None] * oh_e[..., :, None]
                             * oh_c[..., None, :])
        counts = counts + torch.sum(mask_e, dim=2)
    return combine, topi


def _dispatch(dispatch: torch.Tensor, xg: torch.Tensor) -> torch.Tensor:
    """Each expert's capacity buffer (E, B, NG, C, D) from the tokens
    (B, NG, g, D) and the one-hot dispatch (B, NG, g, E, C)."""
    return torch.einsum("bnsec,bnsd->ebncd", dispatch, xg)


def _combine(combine: torch.Tensor, ye: torch.Tensor) -> torch.Tensor:
    """The tokens' outputs (B, NG, g, D) from the experts' (E, B, NG, C, D),
    weighted by the fp32 combine tensor (the JAX einsum promotes ye)."""
    return torch.einsum("bnsec,ebncd->bnsd", combine, ye.float())

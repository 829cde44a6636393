"""AdamW with dtype-configurable moments (twin of repro.optim.adamw).

Plain tensor functions over the parameter tree, not torch.optim.AdamW,
which orders its arithmetic otherwise: the update here is the JAX twin's,
op for op, each op rounded in fp32.  The moments are stored in
`moment_dtype` (bf16 for the giant configs); the update runs in fp32 and
rounds the new parameter back to its own dtype.  `count` is an int32 0-d
tensor.  (The JAX package's train step runs this under jax.jit, where XLA
contracts some products and sums into fused multiply-adds: that run is
within an ulp of the op-for-op one.)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch.optim.clip import tree_leaves, tree_map

__all__ = ["AdamWConfig", "adamw_init", "adamw_update"]

# elements of a leaf updated at once: bounds the update's fp32 temporaries
# (an MoE expert stack of 0.42-0.94 B parameters would take 1.7-3.8 GB each)
_SLICE = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: str = "float32"


def adamw_init(params: Any, cfg: AdamWConfig) -> dict:
    dt = getattr(torch, cfg.moment_dtype)
    device = next(tree_leaves(params)).device

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def _pick(tree: Any, i: int) -> Any:
    """Element i of every (param, mu, nu) tuple of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]


def adamw_update(grads: Any, state: dict, params: Any, cfg: AdamWConfig,
                 lr: torch.Tensor) -> Tuple[Any, dict]:
    """(new params, new state) from gradients of the params' structure; `lr`
    a 0-d fp32 tensor (or a float)."""
    count = state["count"] + 1
    cf = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(cfg.b1, cf)
    bc2 = 1.0 - torch.pow(cfg.b2, cf)
    dt = getattr(torch, cfg.moment_dtype)

    def upd(g, m, v, p):
        g32 = g.to(torch.float32)
        m32 = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * g32
        v32 = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * g32 * g32
        step = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        if cfg.weight_decay:
            step = step + cfg.weight_decay * p.to(torch.float32)
        new_p = (p.to(torch.float32) - lr * step).to(p.dtype)
        return new_p, m32.to(dt), v32.to(dt)

    def upd_leaf(g, m, v, p):
        """upd over slices of p's first axis of at most _SLICE elements: the
        same bits, with fp32 temporaries of a slice, not of the leaf."""
        rows = p.shape[0] if p.dim() else 1
        if p.numel() <= _SLICE or rows == 1:
            return upd(g, m, v, p)
        out = (torch.empty_like(p), torch.empty(m.shape, dtype=dt, device=m.device),
               torch.empty(v.shape, dtype=dt, device=v.device))
        step_rows = max(1, _SLICE // (p.numel() // rows))
        for r0 in range(0, rows, step_rows):
            for dst, part in zip(out, upd(*(x[r0:r0 + step_rows] for x in (g, m, v, p)))):
                dst[r0:r0 + step_rows] = part
        return out

    flat = tree_map(upd_leaf, grads, state["mu"], state["nu"], params)
    return _pick(flat, 0), {"mu": _pick(flat, 1), "nu": _pick(flat, 2), "count": count}

"""RWKV-6 "Finch" mixer (twin of repro.models.rwkv): token-shift plus the
data-dependent-decay WKV recurrence, and the squared-ReLU channel-mix.

State per layer is O(1) in sequence length: head-wise (dh, dh) outer-product
matrices.  The full-sequence time-mix runs its WKV through
kernels.wkv.ops.wkv_chunked: on a CUDA tensor the hand-written kernel (B11),
which also returns the final state for the decode cache; on a CPU tensor the
plain recurrence, which autograd differentiates.  A training call on the
card (grad enabled, an operand requiring it) goes through wkv_train, B11
with its backward kernel, and returns the same state, which carries no
gradient.  Configs with rwkv_chunk > 0, for which the JAX package takes
the chunked form of the same function, run the exact recurrence too.  Decode is the single-step state update in plain PyTorch, as in
the JAX package, which has no kernel for it.

The simplifications against the released checkpoint are the JAX package's:
static token-shift lerps, and the decay keeps its data-dependent LoRA.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.wkv.ops import wkv_chunked, wkv_train
from repro_torch.models import layers as L

__all__ = [
    "rwkv_time_init", "rwkv_time_apply", "rwkv_time_decode",
    "rwkv_chan_init", "rwkv_chan_apply", "rwkv_chan_decode",
    "rwkv_cache_shape",
]

_LORA = 64  # decay LoRA rank


def _heads(cfg):
    dh = cfg.rwkv_head_dim
    return cfg.d_model // dh, dh


def rwkv_time_init(gen: torch.Generator, cfg) -> dict:
    d = cfg.d_model
    dt = cfg.pdtype()
    dev = gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "mu": torch.rand((5, d), generator=gen, **f32).to(dt),    # r,k,v,g,w shift lerps
        "wr": L.dense_init(gen, (d, d), dt),
        "wk": L.dense_init(gen, (d, d), dt),
        "wv": L.dense_init(gen, (d, d), dt),
        "wg": L.dense_init(gen, (d, d), dt),
        "w0": torch.linspace(-6.0, -0.5, d, **f32),                  # base decay
        "w_lora_a": L.dense_init(gen, (d, _LORA), dt),
        "w_lora_b": (torch.randn((_LORA, d), generator=gen, **f32) * 0.01).to(dt),
        "u": torch.randn((d,), generator=gen, **f32) * 0.1,         # bonus, fp32
        "ln_scale": torch.ones((d,), dtype=dt, device=dev),          # per-head group norm
        "wo": L.dense_init(gen, (d, d), dt),
    }


def _shift(x: torch.Tensor, prev: torch.Tensor = None) -> torch.Tensor:
    """Token shift: x_{t-1} (zeros / `prev` before the first token)."""
    if prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, : x.shape[1]]
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _mix(p, x, xs):
    """r,k,v,g,w input streams via per-channel lerp with the shifted token."""
    mu = p["mu"].to(x.dtype)
    return [x + mu[i] * (xs - x) for i in range(5)]  # xr, xk, xv, xg, xw


def _decay(p, xw: torch.Tensor) -> torch.Tensor:
    """Data-dependent decay w_t in (0,1): exp(-exp(w0 + lora(x)))  (fp32)."""
    lora = torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]
    return torch.exp(-torch.exp(p["w0"] + lora.float()))


def _group_norm(p, x: torch.Tensor, h: int, dh: int, eps: float) -> torch.Tensor:
    """Per-head RMS normalisation of the WKV output."""
    shp = x.shape
    xh = x.reshape(*shp[:-1], h, dh).float()
    xh = xh * torch.rsqrt(torch.mean(xh * xh, dim=-1, keepdim=True) + eps)
    return (xh.reshape(shp) * p["ln_scale"].float()).to(x.dtype)


def rwkv_time_apply(p: dict, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence time-mix. x: (B, S, D) -> ((B, S, D), the final WKV
    state (B, H, dh, dh) fp32).
    The JAX twin returns the output only and its prefill replays the
    recurrence for the state (transformer._rwkv_final_state)."""
    # the exact recurrence on both devices, also where cfg.rwkv_chunk > 0
    # makes the JAX package take the chunked form (the same function)
    b, s, d = x.shape
    h, dh = _heads(cfg)
    xs = _shift(x)
    xr, xk, xv, xg, xw = _mix(p, x, xs)
    r = (xr @ p["wr"]).reshape(b, s, h, dh).float()
    k = (xk @ p["wk"]).reshape(b, s, h, dh).float()
    v = (xv @ p["wv"]).reshape(b, s, h, dh).float()
    g = F.silu(xg @ p["wg"])
    w = _decay(p, xw).reshape(b, s, h, dh)                          # (B,S,H,dh)
    u = p["u"].reshape(h, dh)

    train = r.is_cuda and L.needs_grad(r, k, v, w, u)
    out, state = (wkv_train if train else wkv_chunked)(r, k, v, w, u)
    out = out.reshape(b, s, d)
    out = _group_norm(p, out.to(x.dtype), h, dh, cfg.norm_eps) * g
    return out @ p["wo"], state


def rwkv_chan_init(gen: torch.Generator, cfg) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    dt = cfg.pdtype()
    return {
        "mu": torch.rand((2, d), generator=gen, dtype=torch.float32,
                         device=gen.device).to(dt),                 # k, r lerps
        "wk": L.dense_init(gen, (d, f), dt),
        "wv": L.dense_init(gen, (f, d), dt),
        "wr": L.dense_init(gen, (d, d), dt),
    }


def rwkv_chan_apply(p: dict, x: torch.Tensor, cfg, prev=None) -> torch.Tensor:
    xs = _shift(x, prev)
    mu = p["mu"].to(x.dtype)
    xk = x + mu[0] * (xs - x)
    xr = x + mu[1] * (xs - x)
    k = torch.square(F.relu(xk @ p["wk"]))
    return torch.sigmoid(xr @ p["wr"]) * (k @ p["wv"])


def rwkv_cache_shape(cfg, batch: int):
    h, dh = _heads(cfg)
    return {
        "wkv": (batch, h, dh, dh),   # fp32 outer-product state
        "shift_t": (batch, cfg.d_model),
        "shift_c": (batch, cfg.d_model),
    }


def rwkv_time_decode(p: dict, x: torch.Tensor, cache: dict, cfg) -> Tuple[torch.Tensor, dict]:
    """One-token time-mix. x: (B, 1, D)."""
    b, _, d = x.shape
    h, dh = _heads(cfg)
    xt = x[:, 0]
    xs = cache["shift_t"].to(xt.dtype)
    xr, xk, xv, xg, xw = _mix(p, xt[:, None], xs[:, None])
    r = (xr[:, 0] @ p["wr"]).reshape(b, h, dh).float()
    k = (xk[:, 0] @ p["wk"]).reshape(b, h, dh).float()
    v = (xv[:, 0] @ p["wv"]).reshape(b, h, dh).float()
    g = F.silu(xg[:, 0] @ p["wg"])
    w = _decay(p, xw[:, 0]).reshape(b, h, dh)
    u = p["u"].reshape(h, dh)

    kv = k[..., :, None] * v[..., None, :]
    out = torch.einsum("bhk,bhkv->bhv", r, cache["wkv"] + u[None, :, :, None] * kv)
    new_state = w[..., :, None] * cache["wkv"] + kv
    out = out.reshape(b, d).to(x.dtype)
    out = _group_norm(p, out, h, dh, cfg.norm_eps) * g
    out = (out @ p["wo"])[:, None]
    return out, dict(cache, wkv=new_state, shift_t=xt.float())


def rwkv_chan_decode(p: dict, x: torch.Tensor, cache: dict, cfg) -> Tuple[torch.Tensor, dict]:
    xt = x[:, 0]
    out = rwkv_chan_apply(p, x, cfg, prev=cache["shift_c"].to(xt.dtype))
    return out, dict(cache, shift_c=xt.float())

"""Shared neural building blocks (twin of repro.models.layers): plain
functions over parameter dicts.

Conventions, as in the JAX package:
  * params are nested dicts of tensors, weights in the JAX layout (x @ w,
    w of shape (d_in, d_out))
  * activations: (B, S, D); attention heads: (B, S, H, dh)
  * compute dtype from cfg.compute_dtype, fp32 for norms and softmax, the
    result cast back to the input's dtype

Attention on a CUDA tensor runs the hand-written kernels (the routes are
listed in `attention_scores`).  On a CPU tensor it runs the plain functions
here, which autograd differentiates.  The JAX package's sharding
constraints are gone (one device; sharding is ROADMAP A11).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.icoa import NotPortedError
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_train
from repro_torch.kernels.flash_decode.ops import flash_decode

# ---------------------------------------------------------------- init utils


def dense_init(gen: torch.Generator, shape, dtype, scale: Optional[float] = None):
    fan_in = shape[0]
    scale = scale if scale is not None else 1.0 / (fan_in**0.5)
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device) * scale).to(dtype)


# ------------------------------------------------------------------ RMSNorm


def rmsnorm_init(d: int, dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p["scale"].float()).to(x.dtype)


# --------------------------------------------------------------------- RoPE


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,S) -> cos/sin (...,S,head_dim//2), fp32."""
    half = head_dim // 2
    ar = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = 1.0 / (theta ** (ar / half))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B,S,H,dh); cos/sin (B,S,half) or (S,half)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:  # (S, half) -> broadcast over batch and heads
        c = cos[None, :, None, :]
        s = sin[None, :, None, :]
    else:  # (B, S, half)
        c = cos[:, :, None, :]
        s = sin[:, :, None, :]
    xf1, xf2 = x1.float(), x2.float()
    out = torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s], dim=-1)
    return out.to(x.dtype)


def mrope_angles(pos_ids: torch.Tensor, head_dim: int, theta: float,
                 sections: Tuple[int, int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Qwen2-VL M-RoPE: pos_ids (3, B, S), the temporal / height / width
    position ids -> cos/sin (B, S, head_dim//2), fp32.

    The head_dim//2 frequency slots are split into `sections` (t, h, w);
    each slot takes its angle from its section's position stream.  The JAX
    twin picks the stream with a one-hot einsum (a product by 1.0 plus two
    by 0.0: exact); the gather here gives the same fp32 numbers."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {sections} do not sum to {half}")
    slot = torch.arange(half, dtype=torch.int64, device=pos_ids.device)
    freqs = 1.0 / (theta ** (slot.float() / half))
    ang = pos_ids.float()[..., None] * freqs                    # (3, B, S, half)
    # each slot's stream, 0 / 1 / 2, from comparisons on the device (no host
    # sync: repeat_interleave with tensor repeats would read their sum back)
    t, h, _ = sections
    sec_idx = (slot >= t).long() + (slot >= t + h).long()
    ang_sel = torch.gather(ang, 0, sec_idx.expand(1, *ang.shape[1:]))[0]
    return torch.cos(ang_sel), torch.sin(ang_sel)


# ---------------------------------------------------------------- attention


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Grad is enabled and one of `tensors` requires it: a training call,
    which takes a kernel's autograd.Function on the card (serving, whose
    parameters require no grad, keeps the forward-only launch)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def attention_scores(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool, window: int = 0, q_offset: int = 0) -> torch.Tensor:
    """Grouped-query attention.

    q: (B, Sq, Hq, dh); k, v: (B, Skv, Hkv, dh); Hq = Hkv * G.  `q_offset`
    (a host int) is the absolute position of q[0] (decode: the fill
    position).  Sliding `window` > 0 limits lookback.  `causal` masks keys
    after each query; causal=False attends to every key (the JAX twin's
    bidirectional=True, which its encoder and cross-attention pass beside
    causal=False; its ring-buffer decode's `kv_mask` waits for A16(f)).

    On a CUDA tensor:
      * one causal query token (decode) -> flash_decode (B10) at q_offset;
      * one non-causal query token (cross-attention decode) -> flash_decode
        at Skv - 1 with no window: every key of the cache, exactly;
      * a query block at position 0 (prefill; the encoder and
        cross-attention, causal or not) -> flash_attention (B9), or, when
        grad is enabled and an operand requires it (training),
        flash_attention_train (B9 with its backward kernel);
      * a block later in the sequence (chunked prefill) has no kernel yet
        and raises NotPortedError (A16).
    """
    if not _build.on_cpu(q, "attention_scores"):
        if q.shape[1] == 1 and causal:
            return flash_decode(q[:, 0], k, v, q_offset, window=window)[:, None]
        if q.shape[1] == 1 and window == 0 and not needs_grad(q, k, v):
            return flash_decode(q[:, 0], k, v, k.shape[1] - 1)[:, None]
        if q_offset:
            raise NotPortedError(
                f"attention of a {q.shape[1]}-token query block at position "
                f"{q_offset} on the card (chunked prefill) waits for ROADMAP A16")
        if needs_grad(q, k, v):
            return flash_attention_train(q, k, v, causal=causal, window=window)
        return flash_attention(q, k, v, causal=causal, window=window)
    b, sq, hq, dh = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, dh)
    scale = dh**-0.5
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale

    kv_pos = torch.arange(skv, dtype=torch.int64, device=q.device)
    q_pos = torch.arange(sq, dtype=torch.int64, device=q.device) + q_offset
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = kv_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask = mask & (kv_pos[None, :] > q_pos[:, None] - window)
    scores = torch.where(mask[None, None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, sq, hq, dh).to(q.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, window: int = 0, q_offset: int = 0,
                      q_block: int = 512) -> torch.Tensor:
    """Attention with the query axis in blocks of `q_block`: the semantics
    of `attention_scores`, without an (Sq, Skv) score tensor at once.  On a
    CUDA tensor the flash kernel already streams the keys, so the whole
    query axis is one launch."""
    b, sq, hq, dh = q.shape
    if sq <= q_block or not _build.on_cpu(q, "chunked_attention"):
        return attention_scores(q, k, v, causal=causal, window=window, q_offset=q_offset)
    assert sq % q_block == 0, (sq, q_block)
    return torch.cat([attention_scores(q[:, s0:s0 + q_block], k, v, causal=causal,
                                       window=window, q_offset=q_offset + s0)
                      for s0 in range(0, sq, q_block)], dim=1)


def attn_proj_init(gen: torch.Generator, cfg) -> dict:
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    dt = cfg.pdtype()
    p = {
        "wq": dense_init(gen, (d, hq * dh), dt),
        "wk": dense_init(gen, (d, hkv * dh), dt),
        "wv": dense_init(gen, (d, hkv * dh), dt),
        "wo": dense_init(gen, (hq * dh, d), dt),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", hq * dh), ("bk", hkv * dh), ("bv", hkv * dh)):
            p[name] = torch.zeros((n,), dtype=dt, device=gen.device)
    return p


def qkv(p: dict, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return q.reshape(b, s, hq, dh), k.reshape(b, s, hkv, dh), v.reshape(b, s, hkv, dh)


# ------------------------------------------------------------------- SwiGLU


def mlp_init(gen: torch.Generator, d: int, f: int, dtype) -> dict:
    return {
        "wi_gate": dense_init(gen, (d, f), dtype),
        "wi_up": dense_init(gen, (d, f), dtype),
        "wo": dense_init(gen, (f, d), dtype),
    }


def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ p["wi_gate"]) * (x @ p["wi_up"])
    return h @ p["wo"]


def gelu_mlp_init(gen: torch.Generator, d: int, f: int, dtype) -> dict:
    return {"wi": dense_init(gen, (d, f), dtype), "wo": dense_init(gen, (f, d), dtype)}


def gelu_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu's default is the tanh approximation (torch's is erf)."""
    return F.gelu(x @ p["wi"], approximate="tanh") @ p["wo"]


# --------------------------------------------------------------- embeddings


def embed_init(gen: torch.Generator, cfg) -> dict:
    dt = cfg.pdtype()
    p = {"tok": dense_init(gen, (cfg.padded_vocab, cfg.d_model), dt, scale=0.02)}
    if not cfg.tie_embeddings:
        p["out"] = dense_init(gen, (cfg.d_model, cfg.padded_vocab), dt)
    return p


def embed(p: dict, tokens: torch.Tensor, cfg) -> torch.Tensor:
    return p["tok"][tokens].to(cfg.cdtype())


def unembed(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    w = p["tok"].T if cfg.tie_embeddings else p["out"]
    return x @ w.to(cfg.cdtype())


def sinusoidal_positions(s: int, d: int, device) -> torch.Tensor:
    """Whisper-style absolute sinusoidal embeddings (fp32, (S, D)):
    [sin | cos], freqs exp(-k ln(1e4) / (D/2 - 1)) computed in fp32."""
    half = d // 2
    step = torch.log(torch.tensor(10000.0, dtype=torch.float32, device=device)) / (half - 1)
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32, device=device) * step)
    ang = torch.arange(s, dtype=torch.float32, device=device)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)

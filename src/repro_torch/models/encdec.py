"""Whisper-style encoder-decoder backbone (twin of repro.models.encdec), the
`encdec` family.

As in the JAX package, the mel + conv frontend is a stub: the model consumes
precomputed frame embeddings (B, n_frames, D).  Absolute sinusoidal
positions (no RoPE, no qkv bias), pre-norm blocks with tanh-GELU MLPs,
bidirectional encoder self-attention, causal decoder self-attention and
cross-attention into the encoder output.

The JAX package stacks the encoder and decoder layers and scans them; here
`enc_layers` and `dec_layers` are lists of per-layer dicts run by a Python
loop (repro_torch.convert unstacks the JAX tree).  With cfg.remat each
layer of a training pass (grad enabled, the layer's parameters requiring
it) runs under torch.utils.checkpoint, the JAX package's per-layer
jax.checkpoint.

Decode cache: per decoder layer {self_k, self_v (B, max_len, Hkv, dh),
growing; cross_k, cross_v (B, n_frames, Hkv, dh), computed once at prefill
from the encoder output}, in the compute dtype and contiguous (B10 reads
them in place).  A decode step writes its self K/V into the cache in place.
On the card the attention calls take B9 (encoder, prefill self and cross)
and B10 (decode self at idx, decode cross at n_frames - 1), as
layers.attention_scores routes them.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L

__all__ = ["init", "encode", "forward", "prefill", "decode_step", "cache_shapes"]


def _enc_layer_init(gen: torch.Generator, cfg) -> dict:
    dt, dev = cfg.pdtype(), gen.device
    return {
        "norm1": L.rmsnorm_init(cfg.d_model, dt, dev),
        "attn": L.attn_proj_init(gen, cfg),
        "norm2": L.rmsnorm_init(cfg.d_model, dt, dev),
        "ffn": L.gelu_mlp_init(gen, cfg.d_model, cfg.d_ff, dt),
    }


def _dec_layer_init(gen: torch.Generator, cfg) -> dict:
    dt, dev = cfg.pdtype(), gen.device
    return {
        "norm1": L.rmsnorm_init(cfg.d_model, dt, dev),
        "self_attn": L.attn_proj_init(gen, cfg),
        "norm_x": L.rmsnorm_init(cfg.d_model, dt, dev),
        "cross_attn": L.attn_proj_init(gen, cfg),
        "norm2": L.rmsnorm_init(cfg.d_model, dt, dev),
        "ffn": L.gelu_mlp_init(gen, cfg.d_model, cfg.d_ff, dt),
    }


def init(gen: torch.Generator, cfg) -> dict:
    """Random parameters drawn from `gen`, on the generator's device."""
    dt, dev = cfg.pdtype(), gen.device
    return {
        "embed": L.embed_init(gen, cfg),
        "enc_layers": [_enc_layer_init(gen, cfg) for _ in range(cfg.n_enc_layers)],
        "dec_layers": [_dec_layer_init(gen, cfg) for _ in range(cfg.n_layers)],
        "enc_norm": L.rmsnorm_init(cfg.d_model, dt, dev),
        "final_norm": L.rmsnorm_init(cfg.d_model, dt, dev),
    }


def _heads(x: torch.Tensor, w: torch.Tensor, n: int, dh: int) -> torch.Tensor:
    return (x @ w).reshape(x.shape[0], x.shape[1], n, dh)


def _attn(pp, xq, xkv, cfg, *, causal: bool) -> torch.Tensor:
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q, k, v = _heads(xq, pp["wq"], hq, dh), _heads(xkv, pp["wk"], hkv, dh), _heads(xkv, pp["wv"], hkv, dh)
    if cfg.attn_impl == "chunked" and causal and xq.shape[1] > cfg.attn_q_block:
        out = L.chunked_attention(q, k, v, causal=True, q_block=cfg.attn_q_block)
    else:
        out = L.attention_scores(q, k, v, causal=causal)
    return out.reshape(xq.shape[0], xq.shape[1], -1) @ pp["wo"]


def _cross(pp, h, ck, cv, cfg) -> torch.Tensor:
    """Cross-attention of h's queries over the cached encoder K/V."""
    q = _heads(h, pp["wq"], cfg.n_heads, cfg.resolved_head_dim)
    out = L.attention_scores(q, ck, cv, causal=False)
    return out.reshape(h.shape[0], h.shape[1], -1) @ pp["wo"]


def _run(body, x, layers, cfg, *extra):
    """x through `body(x, pp, *extra)` for each layer's pp, each under a
    checkpoint when cfg.remat and the pass is a training one."""
    for pp in layers:
        if cfg.remat and L.needs_grad(x, pp["norm1"]["scale"]):
            x = checkpoint(body, x, pp, *extra, use_reentrant=False)
        else:
            x = body(x, pp, *extra)
    return x


def _enc_body(x, pp, cfg):
    h = L.rmsnorm(pp["norm1"], x, cfg.norm_eps)
    x = x + _attn(pp["attn"], h, h, cfg, causal=False)
    h = L.rmsnorm(pp["norm2"], x, cfg.norm_eps)
    return x + L.gelu_mlp(pp["ffn"], h)


def encode(params, frames: torch.Tensor, cfg) -> torch.Tensor:
    """frames: (B, n_frames, D), the stubbed conv frontend's output."""
    x = frames.to(cfg.cdtype())
    x = x + L.sinusoidal_positions(x.shape[1], cfg.d_model, x.device).to(cfg.cdtype())
    x = _run(_enc_body, x, params["enc_layers"], cfg, cfg)
    return L.rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _embed(params, tokens, cfg) -> torch.Tensor:
    x = L.embed(params["embed"], tokens, cfg)
    return x + L.sinusoidal_positions(tokens.shape[1], cfg.d_model, x.device).to(x.dtype)


def _dec_body(x, pp, enc_out, cfg):
    h = L.rmsnorm(pp["norm1"], x, cfg.norm_eps)
    x = x + _attn(pp["self_attn"], h, h, cfg, causal=True)
    h = L.rmsnorm(pp["norm_x"], x, cfg.norm_eps)
    x = x + _attn(pp["cross_attn"], h, enc_out, cfg, causal=False)
    h = L.rmsnorm(pp["norm2"], x, cfg.norm_eps)
    return x + L.gelu_mlp(pp["ffn"], h)


def forward(params, batch, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward: batch {"frames": (B, F, D), "tokens": (B, S)} ->
    (logits (B, S, V), aux 0)."""
    enc_out = encode(params, batch["frames"], cfg)
    x = _run(_dec_body, _embed(params, batch["tokens"], cfg), params["dec_layers"], cfg,
             enc_out, cfg)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return L.unembed(params["embed"], x, cfg), aux


def cache_shapes(cfg, batch: int, max_len: int):
    """Per decoder layer, {name: (shape, dtype)} of the decode cache."""
    hkv, dh, dt = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.cdtype()
    self_shape, cross_shape = (batch, max_len, hkv, dh), (batch, cfg.n_frames, hkv, dh)
    return [{"self_k": (self_shape, dt), "self_v": (self_shape, dt),
             "cross_k": (cross_shape, dt), "cross_v": (cross_shape, dt)}
            for _ in range(cfg.n_layers)]


def prefill(params, batch, cfg) -> Tuple[torch.Tensor, list]:
    """Encode, then the decoder over the prompt, building the self and cross
    caches.  Returns (last logits (B, V), cache)."""
    enc_out = encode(params, batch["frames"], cfg)
    x = _embed(params, batch["tokens"], cfg)
    hq, hkv, dh, cdt = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.cdtype()
    cache = []
    for pp in params["dec_layers"]:
        h = L.rmsnorm(pp["norm1"], x, cfg.norm_eps)
        sa = pp["self_attn"]
        sk, sv = _heads(h, sa["wk"], hkv, dh), _heads(h, sa["wv"], hkv, dh)
        out = L.attention_scores(_heads(h, sa["wq"], hq, dh), sk, sv, causal=True)
        x = x + out.reshape(x.shape[0], x.shape[1], -1) @ sa["wo"]
        h = L.rmsnorm(pp["norm_x"], x, cfg.norm_eps)
        ca = pp["cross_attn"]
        ck, cv = _heads(enc_out, ca["wk"], hkv, dh), _heads(enc_out, ca["wv"], hkv, dh)
        x = x + _cross(ca, h, ck, cv, cfg)
        h = L.rmsnorm(pp["norm2"], x, cfg.norm_eps)
        x = x + L.gelu_mlp(pp["ffn"], h)
        cache.append({"self_k": sk.to(cdt), "self_v": sv.to(cdt),
                      "cross_k": ck.to(cdt), "cross_v": cv.to(cdt)})
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params["embed"], x[:, -1:], cfg)
    return logits[:, 0], cache


def decode_step(params, batch, cache, cfg) -> Tuple[torch.Tensor, list]:
    """One decoder token. batch: {"tokens": (B, 1), "idx": int}, `idx` the
    fill position (a host int, or a one-element integer tensor).  Returns
    (logits (B, V), cache)."""
    idx = int(batch["idx"])
    tokens = batch["tokens"]
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    x = L.embed(params["embed"], tokens, cfg)
    cache_len = cache[0]["self_k"].shape[1]
    if not 0 <= idx < cache_len:
        raise IndexError(f"decode position {idx} outside the cache of length {cache_len}")
    pos_table = L.sinusoidal_positions(cache_len, cfg.d_model, x.device)
    x = x + pos_table[idx:idx + 1][None].to(x.dtype)
    for pp, c in zip(params["dec_layers"], cache):
        h = L.rmsnorm(pp["norm1"], x, cfg.norm_eps)
        sa = pp["self_attn"]
        kc, vc = c["self_k"], c["self_v"]
        kc[:, idx] = _heads(h, sa["wk"], hkv, dh)[:, 0].to(kc.dtype)   # in place
        vc[:, idx] = _heads(h, sa["wv"], hkv, dh)[:, 0].to(vc.dtype)
        out = L.attention_scores(_heads(h, sa["wq"], hq, dh), kc, vc, causal=True,
                                 q_offset=idx)
        x = x + out.reshape(x.shape[0], 1, -1) @ sa["wo"]
        h = L.rmsnorm(pp["norm_x"], x, cfg.norm_eps)
        x = x + _cross(pp["cross_attn"], h, c["cross_k"], c["cross_v"], cfg)
        h = L.rmsnorm(pp["norm2"], x, cfg.norm_eps)
        x = x + L.gelu_mlp(pp["ffn"], h)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params["embed"], x, cfg)
    return logits[:, 0], cache

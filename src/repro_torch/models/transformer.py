"""Decoder-only transformer assembly (twin of repro.models.transformer) for
the `dense`, `moe`, `ssm` (RWKV-6), `hybrid` (Jamba) and `vlm` (Qwen2-VL's
language path) families.

The JAX package stacks each pattern position's parameters over the layer
repetitions and consumes the stack with `lax.scan`; here the parameters are
a list with one dict per layer and a Python loop runs them (PyTorch runs
eagerly; repro_torch.convert unstacks the JAX tree).  The decode cache is a
list of per-layer dicts likewise: attention layers hold k, v (B, S, Hkv, dh)
in the compute dtype, Mamba layers h (B, di, n) and conv (B, d_conv - 1, di)
in fp32, RWKV layers wkv (B, H, dh, dh), shift_t and shift_c (B, D) in fp32.
Layer i's mixer is cfg.layer_kinds()[i] and its FFN the MoE one where
cfg.layer_is_moe(i) (Jamba: attention at i % 8 == 4, MoE at odd i).  A
decode step writes the new K/V into the cache tensors in place (the JAX
step returns updated copies), which keeps a long cache from being copied
once per token.

`forward` is the training pass.  The JAX package's two-level remat (the
layer stack reshaped to (n_out, scan_block), the inner scan under
jax.checkpoint) is torch.utils.checkpoint (non-reentrant) over each group
of scan_block pattern repetitions: the backward keeps the residual stream
at each group's input and recomputes inside the group, so with remat on
every kernel of a group's forward runs twice a step.  The aux loss is the
sum of the MoE layers' router losses in layer order (the JAX carry's).  The
JAX package's sharding constraints are the identity here (one device;
sharding waits for ROADMAP A11).

The vlm family's vision tower is a stub, as in the JAX package: the batch
carries vision embeddings (B, n_vision_tokens, D), projected by
`vision_proj` and put before the text, and M-RoPE position ids
`pos_ids` (3, B, S) (a decode step's (3, B, 1)).  The enc-dec family is
models/encdec.py; the ring-buffer window cache waits for A16(f)
(models.model.build_model refuses it).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv as R

__all__ = ["pattern_period", "init", "forward", "prefill", "decode_step", "cache_shapes"]


# ----------------------------------------------------------------- pattern


def pattern_period(cfg) -> int:
    if cfg.family == "hybrid":
        p = cfg.attn_period
        if cfg.n_experts:
            p = max(p, cfg.moe_every) if p % cfg.moe_every == 0 else p * cfg.moe_every
        return p
    if cfg.n_experts and cfg.moe_every > 1:
        return cfg.moe_every
    return 1


def _effective_window(cfg) -> int:
    if cfg.sliding_window > 0:
        return cfg.sliding_window
    if cfg.attn_variant == "sliding":
        return 4096
    return 0


# -------------------------------------------------------------------- init


def _layer_init(gen: torch.Generator, cfg, kind: str, is_moe: bool) -> dict:
    dt = cfg.pdtype()
    p: Dict[str, Any] = {"norm1": L.rmsnorm_init(cfg.d_model, dt, gen.device),
                         "norm2": L.rmsnorm_init(cfg.d_model, dt, gen.device)}
    if kind == "attn":
        p["mixer"] = L.attn_proj_init(gen, cfg)
    elif kind == "mamba":
        p["mixer"] = M.mamba_init(gen, cfg)
    elif kind == "rwkv":
        p["mixer"] = R.rwkv_time_init(gen, cfg)
    else:
        raise ValueError(kind)
    if is_moe:
        p["ffn"] = MOE.moe_init(gen, cfg)
    elif kind == "rwkv":
        p["ffn"] = R.rwkv_chan_init(gen, cfg)
    else:
        p["ffn"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff, dt)
    return p


def _layer_moes(cfg) -> List[bool]:
    return [cfg.layer_is_moe(i) for i in range(cfg.n_layers)]


def init(gen: torch.Generator, cfg) -> dict:
    """Random parameters drawn from `gen`, on the generator's device."""
    params = {
        "embed": L.embed_init(gen, cfg),
        "final_norm": L.rmsnorm_init(cfg.d_model, cfg.pdtype(), gen.device),
        "layers": [_layer_init(gen, cfg, kind, is_moe)
                   for kind, is_moe in zip(cfg.layer_kinds(), _layer_moes(cfg))],
    }
    if cfg.family == "vlm":
        params["vision_proj"] = L.dense_init(gen, (cfg.d_model, cfg.d_model), cfg.pdtype())
    return params


# ----------------------------------------------------------------- forward


def _attn_train(pp, x, cfg, rope, window: int):
    q, k, v = L.qkv(pp, x, cfg)
    if rope is not None:
        cos, sin = rope
        q = L.apply_rope(q, cos, sin)
        k = L.apply_rope(k, cos, sin)
    out = _attention(q, k, v, cfg, causal=True, window=window)
    b, s, _, _ = out.shape
    return out.reshape(b, s, -1) @ pp["wo"]


def _apply_layer_train(pp, x, cfg, kind: str, is_moe: bool, rope, window: int):
    """One layer of the training forward: (x, the MoE layer's aux loss, or
    None without an MoE FFN)."""
    aux = None
    h = L.rmsnorm(pp["norm1"], x, cfg.norm_eps)
    if kind == "attn":
        mix = _attn_train(pp["mixer"], h, cfg, rope, window)
    elif kind == "mamba":
        mix = M.mamba_apply(pp["mixer"], h, cfg)
    else:
        mix, _ = R.rwkv_time_apply(pp["mixer"], h, cfg)
    x = x + mix
    h = L.rmsnorm(pp["norm2"], x, cfg.norm_eps)
    if is_moe:
        ffn, aux = MOE.moe_apply(pp["ffn"], h, cfg)
    elif kind == "rwkv":
        ffn = R.rwkv_chan_apply(pp["ffn"], h, cfg)
    else:
        ffn = L.mlp(pp["ffn"], h)
    return x + ffn, aux


def _run_group(x, aux, layers, kinds, moes, cfg, rope, window: int):
    for pp, kind, is_moe in zip(layers, kinds, moes):
        x, a = _apply_layer_train(pp, x, cfg, kind, is_moe, rope, window)
        if a is not None:
            aux = aux + a
    return x, aux


def _run_layers_train(params, x, cfg, rope) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer stack in groups of scan_block pattern repetitions (the JAX
    package's inner scan length: the largest divisor of the repetitions up
    to scan_block), each group under a checkpoint when cfg.remat."""
    period = pattern_period(cfg)
    n_rep = cfg.n_layers // period
    n_in = min(cfg.scan_block, n_rep)
    while n_rep % n_in:
        n_in -= 1
    group = n_in * period
    window = _effective_window(cfg)
    kinds, moes = cfg.layer_kinds(), _layer_moes(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g0 in range(0, cfg.n_layers, group):
        run = functools.partial(_run_group, layers=params["layers"][g0:g0 + group],
                                kinds=kinds[g0:g0 + group], moes=moes[g0:g0 + group],
                                cfg=cfg, rope=rope, window=window)
        x, aux = checkpoint(run, x, aux, use_reentrant=False) if cfg.remat else run(x, aux)
    return x, aux


def _rope_for(cfg, batch, start: int, s: int):
    """(cos, sin) at positions start..start+s-1, or M-RoPE at
    batch["pos_ids"] for the vlm family; None for rwkv and without RoPE."""
    if cfg.family == "ssm" or cfg.rope_theta == 0.0:
        return None
    dh = cfg.resolved_head_dim
    if cfg.family == "vlm":
        return L.mrope_angles(batch["pos_ids"], dh, cfg.rope_theta, cfg.mrope_sections)
    pos = torch.arange(start, start + s, dtype=torch.int64, device=batch["tokens"].device)
    return L.rope_angles(pos, dh, cfg.rope_theta)


def _embed_inputs(params, batch, cfg) -> torch.Tensor:
    """tokens (after the projected vision embeddings for vlm) -> (B, S_total, D)."""
    x = L.embed(params["embed"], batch["tokens"], cfg)
    if cfg.family == "vlm":
        cdt = cfg.cdtype()
        v = batch["vision_embeds"].to(cdt) @ params["vision_proj"].to(cdt)
        x = torch.cat([v, x], dim=1)          # vision tokens prefix the text
    return x


def forward(params, batch, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence causal forward. Returns (logits (B, S_total, V), aux)."""
    x = _embed_inputs(params, batch, cfg)
    rope = _rope_for(cfg, batch, 0, x.shape[1])
    x, aux = _run_layers_train(params, x, cfg, rope)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.unembed(params["embed"], x, cfg), aux


# ------------------------------------------------------------------- cache


def cache_shapes(cfg, batch: int, max_len: int) -> List[Dict[str, Tuple[tuple, torch.dtype]]]:
    """Per layer, {name: (shape, dtype)} of the decode cache."""
    hkv, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    out = []
    for kind in cfg.layer_kinds():
        if kind == "attn":
            out.append({"k": ((batch, max_len, hkv, dh), cfg.cdtype()),
                        "v": ((batch, max_len, hkv, dh), cfg.cdtype())})
        elif kind == "mamba":
            out.append({k: (v, torch.float32)
                        for k, v in M.mamba_cache_shape(cfg, batch).items()})
        else:
            out.append({k: (v, torch.float32)
                        for k, v in R.rwkv_cache_shape(cfg, batch).items()})
    return out


# ------------------------------------------------------------------ layers


def _attention(q, k, v, cfg, **kw):
    if cfg.attn_impl == "chunked" and q.shape[1] > 1:
        return L.chunked_attention(q, k, v, q_block=cfg.attn_q_block, **kw)
    return L.attention_scores(q, k, v, **kw)


def _apply_layer_decode(pp, x, cache, idx: int, cfg, kind, is_moe, rope, window):
    h = L.rmsnorm(pp["norm1"], x, cfg.norm_eps)
    if kind == "attn":
        q, k, v = L.qkv(pp["mixer"], h, cfg)
        if rope is not None:
            cos, sin = rope
            q = L.apply_rope(q, cos, sin)
            k = L.apply_rope(k, cos, sin)
        kc, vc = cache["k"], cache["v"]
        if not 0 <= idx < kc.shape[1]:
            raise IndexError(f"decode position {idx} outside the cache of "
                             f"length {kc.shape[1]}")
        kc[:, idx] = k[:, 0].to(kc.dtype)        # in place: see the module doc
        vc[:, idx] = v[:, 0].to(vc.dtype)
        out = _attention(q, kc, vc, cfg, causal=True, window=window, q_offset=idx)
        mix = out.reshape(x.shape[0], 1, -1) @ pp["mixer"]["wo"]
    elif kind == "mamba":
        mix, cache = M.mamba_decode(pp["mixer"], h, cache, cfg)
    else:
        mix, cache = R.rwkv_time_decode(pp["mixer"], h, cache, cfg)
    x = x + mix
    h = L.rmsnorm(pp["norm2"], x, cfg.norm_eps)
    if is_moe:
        ffn, _ = MOE.moe_apply(pp["ffn"], h, cfg, decode=True)
    elif kind == "rwkv":
        ffn, cache = R.rwkv_chan_decode(pp["ffn"], h, cache, cfg)
    else:
        ffn = L.mlp(pp["ffn"], h)
    return x + ffn, cache


def decode_step(params, batch, cache, cfg) -> Tuple[torch.Tensor, list]:
    """One new token against the cache. batch: {"tokens": (B,1), "idx": int},
    and for vlm "pos_ids" (3, B, 1).

    Returns (logits (B, V), cache).  `idx` is the current fill length, a
    host int (or a one-element integer tensor)."""
    idx = int(batch["idx"])
    x = L.embed(params["embed"], batch["tokens"], cfg)
    rope = _rope_for(cfg, batch, idx, 1)
    window = _effective_window(cfg)
    new_cache = []
    for pp, c, kind, is_moe in zip(params["layers"], cache, cfg.layer_kinds(),
                                   _layer_moes(cfg)):
        x, c = _apply_layer_decode(pp, x, c, idx, cfg, kind, is_moe, rope, window)
        new_cache.append(c)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params["embed"], x, cfg)
    return logits[:, 0], new_cache


def _rwkv_final_state(wkv_state, h):
    """The RWKV layer's decode cache after a full-sequence pass: the WKV
    state that the time-mix returned (the JAX twin replays the recurrence
    for it), the last token for the time shift, and a zero channel shift
    (prefill sets it after the channel-mix)."""
    b, _, d = h.shape
    return {"wkv": wkv_state, "shift_t": h[:, -1].float(),
            "shift_c": torch.zeros((b, d), dtype=torch.float32, device=h.device)}


def prefill(params, batch, cfg) -> Tuple[torch.Tensor, list]:
    """Forward over the prompt, building the cache. Returns (last logits, cache)."""
    window = _effective_window(cfg)
    x = _embed_inputs(params, batch, cfg)
    b, s, _ = x.shape
    rope = _rope_for(cfg, batch, 0, s)
    cache = []
    for pp, kind, is_moe in zip(params["layers"], cfg.layer_kinds(), _layer_moes(cfg)):
        h = L.rmsnorm(pp["norm1"], x, cfg.norm_eps)
        if kind == "attn":
            q, k, v = L.qkv(pp["mixer"], h, cfg)
            if rope is not None:
                cos, sin = rope
                q = L.apply_rope(q, cos, sin)
                k = L.apply_rope(k, cos, sin)
            out = _attention(q, k, v, cfg, causal=True, window=window)
            mix = out.reshape(b, s, -1) @ pp["mixer"]["wo"]
            c = {"k": k.to(cfg.cdtype()), "v": v.to(cfg.cdtype())}
        elif kind == "mamba":
            mix, c = M.mamba_apply(pp["mixer"], h, cfg, final_state=True)
        else:
            mix, state = R.rwkv_time_apply(pp["mixer"], h, cfg)
            c = _rwkv_final_state(state, h)
        x = x + mix
        h = L.rmsnorm(pp["norm2"], x, cfg.norm_eps)
        if is_moe:
            ffn, _ = MOE.moe_apply(pp["ffn"], h, cfg)
        elif kind == "rwkv":
            ffn = R.rwkv_chan_apply(pp["ffn"], h, cfg)
            c["shift_c"] = h[:, -1].float()
        else:
            ffn = L.mlp(pp["ffn"], h)
        x = x + ffn
        cache.append(c)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params["embed"], x[:, -1:], cfg)
    return logits[:, 0], cache

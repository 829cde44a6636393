"""Wrapper of the flash-decode kernel (csrc/flash_decode.cu): `flash_decode`,
twin of repro.kernels.flash_decode.ops.

One new token's attention over a KV cache: q (B, Hq, dh), the cache k, v
(B, S, Hkv, dh) in the JAX layout, positions 0..idx valid (and > idx -
window with a sliding window).  `idx` is a host int shared by the batch, as
the serving engine passes it; the kernel reads only the positions it needs.
q, k and v are one dtype (bf16 or fp32); scores, softmax and sums are fp32,
the output is q's dtype.  The cache must be contiguous (the serving engine's
caches are: `_pad_cache` hands over freshly padded tensors and the decode
step writes them in place).

A CPU tensor runs the plain version (ref.py); a CUDA tensor launches the
kernel or raises.  There is no fallback between the two.
"""
from __future__ import annotations

import functools
import operator

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ops import HEAD_DIMS, check_lm_operands
from repro_torch.kernels.flash_decode.ref import decode_ref

__all__ = ["flash_decode", "decode_geometry", "MAX_GROUP"]

MAX_GROUP = 8           # query heads per KV head (kMaxG in flash_decode.cu)
_WARPS_PER_SM = 16      # chunks in flight per SM the geometry aims at


def decode_geometry(n: int, pairs: int, n_sm: int = 132):
    """(chunk, nsplit) for n attended positions and `pairs` (batch, KV head)
    pairs: chunks of a multiple of 32 positions, about 16 per SM in all."""
    want = max(1, (_WARPS_PER_SM * n_sm) // pairs)
    per_chunk = -(-n // want)
    chunk = max(32, -(-per_chunk // 32) * 32)
    return chunk, -(-n // chunk)


@functools.lru_cache(maxsize=None)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def flash_decode(q, k, v, idx, *, window: int = 0) -> torch.Tensor:
    """q (B,Hq,dh); k,v (B,S,Hkv,dh); idx the fill position (inclusive) ->
    (B,Hq,dh) in q's dtype."""
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_decode: expected q (B,Hq,dh) and k, v "
                         f"(B,S,Hkv,dh), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, dh = q.shape
    _, s, hkv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != dh or hq % hkv:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} does not fit "
                         f"k, v {tuple(k.shape)}")
    idx = operator.index(idx)
    if _build.on_cpu(q, "flash_decode"):
        return decode_ref(q, k, v, idx, window=window)
    bf16 = check_lm_operands("flash_decode", (("q", q), ("k", k), ("v", v)))
    g = hq // hkv
    if dh not in HEAD_DIMS or g > MAX_GROUP:
        raise ValueError(f"flash_decode: head dim {dh} (need one of "
                         f"{HEAD_DIMS}) or group {g} (need <= {MAX_GROUP}) "
                         f"not supported")
    hi = min(idx + 1, s)
    lo = max(0, idx - window + 1) if window > 0 else 0
    if b == 0 or lo >= hi:
        raise ValueError(f"flash_decode: no cache position to attend "
                         f"(B={b}, S={s}, idx={idx}, window={window})")
    chunk, nsplit = decode_geometry(hi - lo, b * hkv, _n_sm(q.device.index or 0))
    f32 = dict(dtype=torch.float32, device=q.device)
    part_m = torch.empty((b, hkv, nsplit, g), **f32)
    part_l = torch.empty((b, hkv, nsplit, g), **f32)
    part_acc = torch.empty((b, hkv, nsplit, g, dh), **f32)
    out = torch.empty_like(q)
    _build.launch("flash_decode", "repro_flash_decode", q, k, v, part_m,
                  part_l, part_acc, out, int(bf16), b, s, hkv, g, dh, lo, hi,
                  chunk, nsplit, dh ** -0.5)
    _build.LAUNCHES["flash_decode"] += 1
    return out

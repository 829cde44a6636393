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

The kernel is one launch per call.  `decode_geometry` (pure Python, pinned
by the CPU tests) cuts the attended positions into chunks of whole tiles,
enough of them for about two blocks streaming K and V on every SM; the tile
size and the group limit are the kernel's own, read from its library by
`tile_positions` and `max_group`.  Each chunk's block merges its partial
softmax into the (batch, KV head)'s result in chunk order when it is the
last to finish.  The partials and the per-(batch, KV head) arrival counters
live in a workspace kept per device and stream (`_workspace`): the counters
are zeroed once and every call leaves them zero.

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

__all__ = ["flash_decode", "decode_geometry", "partial_floats", "tile_positions",
           "max_group"]

BLOCKS_PER_SM = 2       # blocks of ~48 KB in flight the geometry asks of each SM
MAX_CHUNK_TILES = 64    # longest chunk: keeps the last wave short on long caches


@functools.lru_cache(maxsize=None)
def tile_positions(dh: int, itemsize: int) -> int:
    """Positions per K/V tile of the kernel for (dh, element size), as its
    library reports it (0 for a pair it does not serve).  Needs the card."""
    return _build.query("flash_decode", "repro_flash_decode_tile", dh, itemsize)


@functools.lru_cache(maxsize=None)
def max_group() -> int:
    """The most query heads per KV head the kernel serves (its library's
    limit).  Needs the card."""
    return _build.query("flash_decode", "repro_flash_decode_max_group")


def decode_geometry(n: int, pairs: int, tile: int, n_sm: int = 132):
    """(chunk, nsplit) for n >= 1 attended positions of `pairs` (batch, KV
    head) pairs: chunks of whole `tile`-position tiles, at most
    MAX_CHUNK_TILES of them, no chunk empty, and about BLOCKS_PER_SM * n_sm
    blocks in all where the cache has that many tiles (whole tiles per
    chunk can round the count down, never below half of it)."""
    tiles = -(-n // tile)
    want = max(-(-BLOCKS_PER_SM * n_sm // pairs), -(-tiles // MAX_CHUNK_TILES))
    per = -(-tiles // min(tiles, want))          # tiles per chunk
    return per * tile, -(-tiles // per)


def partial_floats(pairs: int, nsplit: int, g: int, dh: int) -> int:
    """fp32 scratch of one call: (m, l, acc[dh]) per (pair, chunk, head)."""
    return pairs * nsplit * g * (dh + 2) if nsplit > 1 else 0


_WORKSPACES = {}


def _workspace(device: torch.device, stream: int, pairs: int, n_part: int):
    """(arrival counters, partials) of at least `pairs` ints and `n_part`
    floats for calls on (device, stream), grown on demand.  The counters are
    zeroed when made and every kernel leaves them zero."""
    key = (str(device), stream)
    arrivals, part = _WORKSPACES.get(key, (None, None))
    if arrivals is None or arrivals.numel() < pairs:
        arrivals = torch.zeros(max(pairs, 64), dtype=torch.int32, device=device)
    if part is None or part.numel() < max(n_part, 1):
        part = torch.empty(max(n_part, 1024), dtype=torch.float32, device=device)
    _WORKSPACES[key] = (arrivals, part)
    return arrivals, part


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
    tile = tile_positions(dh, q.element_size())
    if not tile or g > max_group():
        raise ValueError(f"flash_decode: head dim {dh} (need one of "
                         f"{HEAD_DIMS}) or group {g} (need <= {max_group()}) "
                         f"not supported")
    hi = min(idx + 1, s)
    lo = max(0, idx - window + 1) if window > 0 else 0
    if b == 0 or lo >= hi:
        raise ValueError(f"flash_decode: no cache position to attend "
                         f"(B={b}, S={s}, idx={idx}, window={window})")
    chunk, nsplit = decode_geometry(hi - lo, b * hkv, tile, _build.sm_count(q.device.index or 0))
    arrivals, part = _workspace(q.device, torch.cuda.current_stream(q.device).cuda_stream,
                                b * hkv, partial_floats(b * hkv, nsplit, g, dh))
    out = torch.empty_like(q)
    _build.launch("flash_decode", "repro_flash_decode", q, k, v, part, arrivals,
                  out, int(bf16), b, s, hkv, g, dh, lo, hi, chunk, nsplit,
                  dh ** -0.5)
    _build.LAUNCHES["flash_decode"] += 1
    return out

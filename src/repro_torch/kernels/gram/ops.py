"""Wrappers of the residual Gram kernels (csrc/gram.cu): `gram` and `row_gram`.

Twins of repro.kernels.gram.ops (B1/B2: gram_pallas and its batched form;
B3/B4: row_gram_pallas and its batched form).  The numerical contract is
the TPU kernels': inputs read as fp32, fp32 FMA with fp32 sums (no TF32),
fp32 out (callers cast back to the residual dtype, as
repro.core.covariance does).  The kernels take the natural (D, N) and (N,)
shapes: the TPU's 128-lane padding and (8, Np) pack of v are gone.

On the H100, gram is bound by its FMAs and row_gram by the read of R
(csrc/gram.cu's header has the designs).  What is decided here, in pure
functions the CPU tests hold:

- `gram_block(d)`: the gram block — 32-lane groups of threads, one per 8x8
  micro-tile on or above the diagonal of a 128-row tile (91 at D=100), kg
  such groups per block splitting each step's instances, and the shared
  memory of its 3-stage ring.
- `gram_geometry(d, n, n_sm, blocks_per_sm)`: the N-chunk, a whole number
  of steps, and enough chunks to fill one wave of the card.  A second
  launch sums the chunks in a fixed order.
- `row_gram_geometry(n, n_sm, blocks_per_sm)`: the strip of N a block
  streams (a multiple of 128 columns, at most 1024), sized so that the
  grid is whole waves.  The sum over strips happens in the same launch:
  the last block of a trial to arrive adds them in block order, picked by
  an integer counter that lives in a workspace kept per device and stream
  (`_build.arrivals`), zeroed once and left zero by every call.

Blocks per SM come from the kernels' library (occupancy at their
registers and shared memory), so they need the card.  The 16-byte load
path runs where N % 4 == 0 and the tensors start on 16 bytes; else the
same kernels load 4 bytes at a time (same sums, same bits).

Both functions take an optional leading Monte-Carlo trial axis: a
(B, D, N) residual goes to the batched launch (the twin of the JAX
package's custom_vmap rules, repro/kernels/gram/ops.py), which gives trial
b the single-trial geometry and summation order, so slice b equals the
single-trial result bit for bit.  `row_gram` broadcasts a v of shape (N,)
to every trial.

A CPU tensor runs the plain version (ref.py); a CUDA tensor launches the
kernel or raises.  There is no fallback between the two.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import as_f32
from repro_torch.kernels.gram.ref import (gram_batched_ref, gram_ref,
                                          row_gram_batched_ref, row_gram_ref)

__all__ = ["gram", "row_gram", "gram_block", "gram_geometry",
           "row_gram_geometry", "row_gram_partial_floats", "aligned16",
           "blocks_per_sm"]

GRAM_TILE = 128        # tile edge (kTile in gram.cu)
GRAM_MICRO = 8         # micro-tile edge
GRAM_BK = 32           # instances per thread group per step
GRAM_STAGES = 3        # ring depth
GRAM_MAX_THREADS = 384
GRAM_MAX_GROUPS = 4
GRAM_MAX_SHARED = 232448   # an H100 block's shared memory (bytes)
ROW_GRAM_SLICE = 128   # columns a warp reads per 16-byte slice of its lanes
ROW_GRAM_MAX_SLICES = 8


def gram_block(d: int) -> Tuple[int, int, int]:
    """(threads, kg, shared-memory bytes) of the gram block for D = d.

    A thread group has one thread per 8x8 micro-tile it computes, rounded
    up to whole warps: at d <= 128 the micro-tiles on or above the
    diagonal of the one tile, above it the 16 x 16 of a tile pair.  The
    block holds the most groups (at most GRAM_MAX_GROUPS) that fit in
    GRAM_MAX_THREADS threads and in shared memory; its ring holds, per
    stage, the slabs of 32 kg instances of the pair's rows (each 8-row
    group padded by 16 bytes)."""
    if d <= GRAM_TILE:
        g = -(-d // GRAM_MICRO)
        gt, groups = 32 * -(-(g * (g + 1) // 2) // 32), g
    else:
        gt, groups = 256, 2 * (GRAM_TILE // GRAM_MICRO)
    for kg in range(GRAM_MAX_GROUPS, 0, -1):
        ring = GRAM_STAGES * groups * (GRAM_MICRO * GRAM_BK * kg + 4) * 4
        sums = (kg - 1) * GRAM_MICRO * GRAM_MICRO * gt * 4   # the groups' sums
        smem = max(ring, sums)
        if kg * gt <= GRAM_MAX_THREADS and smem <= GRAM_MAX_SHARED:
            return gt * kg, kg, smem
    raise AssertionError(f"gram: no block for D={d}")


def gram_pairs(d: int) -> int:
    tiles = -(-d // GRAM_TILE)
    return tiles * (tiles + 1) // 2


def gram_geometry(d: int, n: int, n_sm: int = 132,
                  blocks_per_sm: int = 1) -> Tuple[int, int]:
    """(chunk, splits) of the N axis: chunks of whole steps (32 kg
    instances) and at most one wave of blocks, tile pairs x splits <=
    n_sm x blocks_per_sm, as close to it as whole steps allow."""
    _, kg, _ = gram_block(d)
    step = GRAM_BK * kg
    want = max(1, n_sm * blocks_per_sm // gram_pairs(d))
    chunk = step * -(-(-(-n // want)) // step)
    return chunk, -(-n // chunk)


def row_gram_geometry(n: int, n_sm: int = 132,
                      blocks_per_sm: int = 2) -> Tuple[int, int]:
    """(strip, blocks) of the N axis for row_gram: the fewest waves of
    n_sm x blocks_per_sm blocks at which a strip of at most 1024 columns
    covers N, then the narrowest strip (a multiple of 128) that covers N
    in that many waves."""
    slots = n_sm * blocks_per_sm
    widest = ROW_GRAM_SLICE * ROW_GRAM_MAX_SLICES
    waves = -(-(-(-n // widest)) // slots)
    strip = ROW_GRAM_SLICE * -(-n // (ROW_GRAM_SLICE * waves * slots))
    return strip, -(-n // strip)


def row_gram_partial_floats(d: int, blocks: int) -> int:
    """fp32 scratch of one trial: a row sum per (row, strip), each row's
    strips padded to a multiple of 4 for 16-byte loads."""
    return d * (-(-blocks // 4) * 4)


@functools.lru_cache(maxsize=None)
def blocks_per_sm(kind: str, threads: int = 0, kg: int = 0, smem: int = 0) -> int:
    """Blocks of the gram ("gram", with its threads, groups and shared memory) or
    row_gram ("row_gram") kernel that one SM holds, from the library's
    occupancy query.  Needs the card."""
    got = _build.query("gram", "repro_gram_blocks_per_sm",
                       0 if kind == "gram" else 1, kg, threads, smem)
    if got < 1:
        raise RuntimeError(f"{kind}: the card holds no block of {threads} threads "
                           f"and {smem} bytes of shared memory")
    return got


def aligned16(n: int, *tensors: torch.Tensor) -> int:
    """1 where the 16-byte load path may run: rows of N floats start on 16
    bytes when N % 4 == 0 and each tensor does."""
    return int(n % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def gram(r: torch.Tensor) -> torch.Tensor:
    """(D, N) -> fp32 (D, D) = R @ R^T with fp32 accumulation; (B, D, N) ->
    fp32 (B, D, D), one product per trial."""
    if r.dim() not in (2, 3):
        raise ValueError(f"gram: expected a (D, N) or (B, D, N) residual, "
                         f"got {tuple(r.shape)}")
    batched = r.dim() == 3
    if _build.on_cpu(r, "gram"):
        return gram_batched_ref(r) if batched else gram_ref(r)
    _build.check_cuda_tensor("gram: r", r)
    d, n = r.shape[-2:]
    r32 = as_f32(r)
    threads, kg, smem = gram_block(d)
    # the single-trial geometry for every trial, never shrunk for the batch
    chunk, splits = gram_geometry(d, n, _build.sm_count(r.device.index or 0),
                                  blocks_per_sm("gram", threads, kg, smem))
    b = r.shape[0] if batched else 1
    f32 = dict(dtype=torch.float32, device=r.device)
    part = torch.empty((b, splits, d, d), **f32)
    out = torch.empty((b, d, d) if batched else (d, d), **f32)
    geometry = (d, n, chunk, splits, threads, kg, smem, aligned16(n, r32))
    if batched:
        _build.launch("gram", "repro_gram_batched", r32, part, out, *geometry, b)
        _build.LAUNCHES["gram_batched"] += 1
    else:
        _build.launch("gram", "repro_gram", r32, part, out, *geometry)
        _build.LAUNCHES["gram"] += 1
    return out


def row_gram(v: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(N,), (D, N) -> fp32 (D,) = R @ v with fp32 accumulation — the
    incremental engine's one O(N*D) product per probe and per commit.
    Batched: (B, N) or a shared (N,), (B, D, N) -> fp32 (B, D)."""
    if r.dim() not in (2, 3):
        raise ValueError(f"row_gram: expected a (D, N) or (B, D, N) residual, "
                         f"got {tuple(r.shape)}")
    batched = r.dim() == 3
    n = r.shape[-1]
    if batched and tuple(v.shape) not in ((n,), (r.shape[0], n)):
        raise ValueError(f"row_gram: expected v of shape ({n},) or "
                         f"{(r.shape[0], n)}, got {tuple(v.shape)}")
    if _build.on_cpu(r, "row_gram"):
        return row_gram_batched_ref(v, r) if batched else row_gram_ref(v, r)
    d = r.shape[-2]
    _build.check_cuda_tensor("row_gram: r", r)
    _build.check_cuda_tensor("row_gram: v", v, None if batched else (n,))
    r32, v32 = as_f32(r), as_f32(v)
    strip, blocks = row_gram_geometry(n, _build.sm_count(r.device.index or 0),
                                      blocks_per_sm("row_gram"))
    b = r.shape[0] if batched else 1
    arrivals = _build.arrivals(r.device, b)
    part = torch.empty((b, row_gram_partial_floats(d, blocks)), dtype=torch.float32,
                       device=r.device)
    out = torch.empty((b, d) if batched else (d,), dtype=torch.float32, device=r.device)
    aligned = aligned16(n, r32, v32)
    if not batched:
        _build.launch("gram", "repro_row_gram", r32, v32, part, arrivals, out, d, n,
                      strip, aligned)
        _build.LAUNCHES["row_gram"] += 1
        return out
    v_stride = n if v.dim() == 2 else 0       # 0: one v shared by every trial
    _build.launch("gram", "repro_row_gram_batched", r32, v32, part, arrivals, out,
                  d, n, strip, v_stride, aligned, b)
    _build.LAUNCHES["row_gram_batched"] += 1
    return out

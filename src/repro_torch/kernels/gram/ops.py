"""Wrappers of the residual Gram kernels (csrc/gram.cu): `gram` and `row_gram`.

Twins of repro.kernels.gram.ops.  The numerical contract is the TPU
kernels': inputs read as fp32, fp32 accumulation, fp32 out (callers cast
back to the residual dtype, as repro.core.covariance does).  The TPU layout
tricks — D padded to 128 lanes, the (8, Np) row pack of v — are gone: the
kernels take the natural (D, N) and (N,) shapes.

Both take an optional leading Monte-Carlo trial axis: a (B, D, N) residual
goes to the batched kernel (the twin of the JAX package's custom_vmap rules,
repro/kernels/gram/ops.py), which gives trial b the single-trial kernel's
blocks and summation order, so slice b equals the single-trial result bit
for bit.  `row_gram` broadcasts a v of shape (N,) to every trial.

A CPU tensor runs the plain version (ref.py); a CUDA tensor launches the
kernel or raises.  There is no fallback between the two.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import as_f32
from repro_torch.kernels.gram.ref import (gram_batched_ref, gram_ref,
                                          row_gram_batched_ref, row_gram_ref)

__all__ = ["gram", "row_gram", "gram_geometry", "ROW_GRAM_BN"]

_TILE = 64          # output tile edge of gram_partial_kernel
_BK = 32            # instances per shared-memory step
ROW_GRAM_BN = 1024  # columns per row_gram block (kRowBn in gram.cu)


def gram_geometry(d: int, n: int, n_sm: int = 132) -> Tuple[int, int]:
    """(chunk, splits) of the N axis for the gram kernel: enough splits that
    the upper-triangle tile pairs times the splits give about four blocks
    per SM, each chunk a multiple of the 32-instance shared-memory step."""
    tiles = -(-d // _TILE)
    pairs = tiles * (tiles + 1) // 2
    want = max(1, (4 * n_sm) // pairs)
    per_split = -(-n // want)
    chunk = max(_BK, -(-per_split // _BK) * _BK)
    return chunk, -(-n // chunk)


@functools.lru_cache(maxsize=None)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    # the single-trial geometry for every trial, never shrunk for the batch
    chunk, splits = gram_geometry(d, n, _n_sm(r.device.index or 0))
    f32 = dict(dtype=torch.float32, device=r.device)
    if not batched:
        part = torch.empty((splits, d, d), **f32)
        out = torch.empty((d, d), **f32)
        _build.launch("gram", "repro_gram", r32, part, out, d, n, chunk, splits)
        _build.LAUNCHES["gram"] += 1
        return out
    b = r.shape[0]
    part = torch.empty((b, splits, d, d), **f32)
    out = torch.empty((b, d, d), **f32)
    _build.launch("gram", "repro_gram_batched", r32, part, out, d, n, chunk,
                  splits, b)
    _build.LAUNCHES["gram_batched"] += 1
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
    nb = math.ceil(n / ROW_GRAM_BN)
    f32 = dict(dtype=torch.float32, device=r.device)
    if not batched:
        part = torch.empty((nb, d), **f32)
        out = torch.empty((d,), **f32)
        _build.launch("gram", "repro_row_gram", as_f32(r), as_f32(v), part,
                      out, d, n)
        _build.LAUNCHES["row_gram"] += 1
        return out
    b = r.shape[0]
    part = torch.empty((b, nb, d), **f32)
    out = torch.empty((b, d), **f32)
    v_stride = n if v.dim() == 2 else 0       # 0: one v shared by every trial
    _build.launch("gram", "repro_row_gram_batched", as_f32(r), as_f32(v), part,
                  out, d, n, v_stride, b)
    _build.LAUNCHES["row_gram_batched"] += 1
    return out

"""Wrapper of the WKV kernel (csrc/wkv.cu): `wkv_chunked`, twin of
repro.kernels.wkv.ops.

The RWKV-6 recurrence over a whole sequence: r, k, v, w (B, S, H, dh) fp32,
u (H, dh) fp32 -> out (B, S, H, dh) fp32 and the final state (B, H, dh, dh)
that the prefill hands to the decode cache (the JAX op returns out only).

A CPU tensor runs the exact per-token recurrence (ref.wkv_ref, the JAX op's
use_pallas=False form).  A CUDA tensor launches the kernel, which computes
the same function in chunks of CHUNK tokens in an overflow-safe form: every
decay factor is a product of w's inside a chunk, never a quotient, so it can
underflow to 0 but not overflow (ref.wkv_safe_chunked_ref spells the
algorithm out in PyTorch).  The JAX package's chunked form divides by the
cumulative decay and overflows fp32 at strong decay; the port keeps it only
as a twin (ref.wkv_chunked_ref), never as a route, also for configs with
rwkv_chunk > 0.  There is no fallback between the two devices.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.wkv.ref import wkv_ref

__all__ = ["wkv_chunked", "wkv_geometry", "wkv_smem_bytes", "CHUNK", "HEAD_DIMS"]

HEAD_DIMS = (32, 64)    # the rwkv configs' head dims
CHUNK = 16              # tokens per chunk of the kernel (its MMA row tile)
RAW_STAGES = 3          # chunks of r, k, v, w in shared memory (1 loading ahead)
_PAD, _SCORE_ROW = 8, 20


def wkv_smem_bytes(dh: int) -> int:
    """Dynamic shared memory of one block at head dim dh (csrc/wkv.cu Wkv):
    RAW_STAGES stages of r, k, v, w, two operand stages (r * Pex and k * Sfx,
    two CHUNK x 20 score tiles and dh decays), the two CHUNK/2-row factors of
    the scores across the chunk's halves, and u; rows of dh + 8 floats."""
    tile = CHUNK * (dh + _PAD)
    stage = 2 * tile + 2 * CHUNK * _SCORE_ROW + dh
    cross = 2 * (CHUNK // 2) * (dh + _PAD)
    return 4 * (RAW_STAGES * 4 * tile + 2 * stage + cross + dh)


def wkv_geometry(b: int, s: int, h: int, dh: int) -> dict:
    """The launch of one call: a block per (head, batch) of 4 dh threads (dh/16
    prep warps and dh/16 MMA warps of 16 value columns each) walking
    ceil(s / CHUNK) chunks; it depends on the shape alone."""
    if dh not in HEAD_DIMS:
        raise ValueError(f"wkv: head dim {dh} not in {HEAD_DIMS}")
    return {"grid": (h, b), "threads": 4 * dh, "chunks": -(-s // CHUNK),
            "smem_bytes": wkv_smem_bytes(dh)}


def wkv_chunked(r, k, v, w, u):
    """(out (B,S,H,dh) fp32, final state (B,H,dh,dh) fp32)."""
    if r.dim() != 4 or not (r.shape == k.shape == v.shape == w.shape):
        raise ValueError(f"wkv: expected r, k, v, w of one shape (B,S,H,dh), got "
                         f"{[tuple(t.shape) for t in (r, k, v, w)]}")
    b, s, h, dh = r.shape
    if tuple(u.shape) != (h, dh):
        raise ValueError(f"wkv: expected u of shape {(h, dh)}, got {tuple(u.shape)}")
    if _build.on_cpu(r, "wkv"):
        return wkv_ref(r, k, v, w, u)
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u)):
        _build.check_cuda_tensor(f"wkv: {name}", t)
        if t.dtype != torch.float32:
            raise TypeError(f"wkv: {name} must be fp32, got {t.dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"wkv: head dim {dh} not in {HEAD_DIMS}")
    if b * s * h == 0:
        raise ValueError(f"wkv: empty operand {tuple(r.shape)}")
    out = torch.empty_like(r)
    state = torch.empty((b, h, dh, dh), dtype=torch.float32, device=r.device)
    aligned = int(all(t.data_ptr() % 16 == 0 for t in (r, k, v, w)))
    _build.launch("wkv", "repro_wkv", r, k, v, w, u, out, state, b, s, h, dh, aligned)
    _build.LAUNCHES["wkv"] += 1
    return out, state

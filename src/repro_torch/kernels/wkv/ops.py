"""Wrapper of the WKV kernel (csrc/wkv.cu): `wkv_chunked`, twin of
repro.kernels.wkv.ops.

The RWKV-6 recurrence over a whole sequence: r, k, v, w (B, S, H, dh) fp32,
u (H, dh) fp32 -> out (B, S, H, dh) fp32 and the final state (B, H, dh, dh)
that the prefill hands to the decode cache (the JAX op returns out only).
Both devices run the exact per-token recurrence (the JAX op's use_pallas=False
form), which has no overflow to guard against, also for configs with
rwkv_chunk > 0: the chunked form (ref.wkv_chunked_ref) computes the same
function and is kept as the twin of the JAX model's, not as a route.

A CPU tensor runs the plain version (ref.py); a CUDA tensor launches the
kernel or raises.  There is no fallback between the two.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.wkv.ref import wkv_ref

__all__ = ["wkv_chunked", "HEAD_DIMS"]

HEAD_DIMS = (32, 64)    # the rwkv configs' head dims


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
    _build.launch("wkv", "repro_wkv", r, k, v, w, u, out, state, b, s, h, dh)
    _build.LAUNCHES["wkv"] += 1
    return out, state

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

Training (`wkv_train`, a torch.autograd.Function): the forward is the same
launch; the backward, `wkv_bwd`, is one C entry of three launches
(csrc/wkv.cu namespace wkvb): the state at the start of every BWD_CHUNK-token
chunk; the reverse pass, the chunked form of the reverse recurrence on the
tensor cores (mma.sync 3xTF32), a block per BWD_ROWS key rows of a (batch,
head) carrying dL/dS backward across chunks (ref.wkv_bwd_chunked_ref spells
the algorithm out); then dv summed over a head's row blocks and du over the
batch, in order.  Every decay factor is a product of w's inside a chunk, and
dw leaves w_t out by products too: nothing is divided by w, which reaches 0
in fp32.  Bound by the bytes (0.0902 ms at rwkv6's training shape, B=4,
S=1024, 32 heads of 64); 0.5515 ms there on an H100 (the sequential kernel
2.7259 before; chip_smoke phase 12).  `wkv_bwd_geometry` gives the launch
and the scratch; misaligned operands are copied to aligned storage first.
`_build.LAUNCHES["wkv_bwd"]` counts its calls.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.wkv.ref import wkv_bwd_ref, wkv_ref

__all__ = ["wkv_chunked", "wkv_bwd", "wkv_train", "wkv_geometry", "wkv_smem_bytes",
           "wkv_bwd_geometry", "wkv_bwd_smem_bytes", "CHUNK", "BWD_CHUNK", "BWD_ROWS",
           "HEAD_DIMS"]

HEAD_DIMS = (32, 64)    # the rwkv configs' head dims
CHUNK = 16              # tokens per chunk of the kernel (its MMA row tile)
RAW_STAGES = 3          # chunks of r, k, v, w in shared memory (1 loading ahead)
BWD_CHUNK = CHUNK       # tokens a chunk of the backward (its saved states' spacing)
BWD_ROWS = 32           # key rows of S and G a block of the backward owns
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


def wkv_bwd_smem_bytes(dh: int) -> int:
    """Dynamic shared memory of one reverse-pass block at head dim dh
    (csrc/wkv.cu wkvb::Bwd): three raw stages of the r, k, w slices (CHUNK
    rows of BWD_ROWS + 8 floats), two stages of v, g (CHUNK rows of dh + 8)
    and S0 (BWD_ROWS rows), two operand stages of the forward's prep at
    BWD_ROWS columns, its cross factors, u, two buffers of G (BWD_ROWS
    rows), X and Y (CHUNK rows of BWD_ROWS + 4), B (CHUNK rows of 20), c0
    and the four consumer warps' du."""
    tile = CHUNK * (BWD_ROWS + _PAD)
    vp = dh + _PAD
    stage = 2 * tile + 2 * CHUNK * _SCORE_ROW + BWD_ROWS
    cross = 2 * (CHUNK // 2) * (BWD_ROWS + _PAD)
    return 4 * (RAW_STAGES * 3 * tile + 2 * (2 * CHUNK * vp + BWD_ROWS * vp) + 2 * stage
                + cross + BWD_ROWS + 2 * BWD_ROWS * vp + 2 * CHUNK * (BWD_ROWS + 4)
                + CHUNK * _SCORE_ROW + 5 * BWD_ROWS)


def wkv_bwd_geometry(b: int, s: int, h: int, dh: int) -> dict:
    """The reverse pass of one call: a block of 192 threads (two prep warps,
    four consumer warps) per BWD_ROWS key rows of a (head, batch), dh /
    BWD_ROWS blocks a head, walking ceil(s / BWD_CHUNK) chunks from the
    last; and its scratch in floats: the chunk-start states (B, H, splits,
    chunks, BWD_ROWS, dh), dv's per-block shares (splits, B, S, H, dh) and
    du's per-batch ones (B, H, dh).  It depends on the shape alone."""
    if dh not in HEAD_DIMS:
        raise ValueError(f"wkv_bwd: head dim {dh} not in {HEAD_DIMS}")
    splits, chunks = dh // BWD_ROWS, -(-s // BWD_CHUNK)
    return {"grid": (splits * h, b), "threads": 192, "chunks": chunks, "splits": splits,
            "smem_bytes": wkv_bwd_smem_bytes(dh),
            "states": (b, h, splits, chunks, BWD_ROWS, dh),
            "dv_part": (splits, b, s, h, dh), "du_part": (b, h, dh)}


def _check(op: str, r, k, v, w, u) -> Tuple[int, int, int, int]:
    if r.dim() != 4 or not (r.shape == k.shape == v.shape == w.shape):
        raise ValueError(f"{op}: expected r, k, v, w of one shape (B,S,H,dh), got "
                         f"{[tuple(t.shape) for t in (r, k, v, w)]}")
    b, s, h, dh = r.shape
    if tuple(u.shape) != (h, dh):
        raise ValueError(f"{op}: expected u of shape {(h, dh)}, got {tuple(u.shape)}")
    return b, s, h, dh


def _check_cuda(op: str, named) -> None:
    for name, t in named:
        _build.check_cuda_tensor(f"{op}: {name}", t)
        if t.dtype != torch.float32:
            raise TypeError(f"{op}: {name} must be fp32, got {t.dtype}")


def wkv_chunked(r, k, v, w, u):
    """(out (B,S,H,dh) fp32, final state (B,H,dh,dh) fp32)."""
    b, s, h, dh = _check("wkv", r, k, v, w, u)
    if _build.on_cpu(r, "wkv"):
        return wkv_ref(r, k, v, w, u)
    _check_cuda("wkv", (("r", r), ("k", k), ("v", v), ("w", w), ("u", u)))
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


def wkv_bwd(r, k, v, w, u, dout) -> Tuple[torch.Tensor, ...]:
    """(dr, dk, dv, dw (B,S,H,dh), du (H,dh)) fp32: the gradient of
    wkv_chunked's output at (r, k, v, w, u) against its gradient `dout`."""
    b, s, h, dh = _check("wkv_bwd", r, k, v, w, u)
    if dout.shape != r.shape:
        raise ValueError(f"wkv_bwd: dout {tuple(dout.shape)} does not fit r {tuple(r.shape)}")
    if _build.on_cpu(r, "wkv_bwd"):
        return wkv_bwd_ref(r, k, v, w, u, dout)
    _check_cuda("wkv_bwd", (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
                            ("dout", dout)))
    if dh not in HEAD_DIMS:
        raise ValueError(f"wkv_bwd: head dim {dh} not in {HEAD_DIMS}")
    if b * s * h == 0:
        raise ValueError(f"wkv_bwd: empty operand {tuple(r.shape)}")
    geo = wkv_bwd_geometry(b, s, h, dh)
    r, k, v, w, u, dout = (t if t.data_ptr() % 16 == 0 else t.clone()
                           for t in (r, k, v, w, u, dout))
    f32 = dict(dtype=torch.float32, device=r.device)
    states = torch.empty(geo["states"], **f32)
    dv_part = torch.empty(geo["dv_part"], **f32)
    du_part = torch.empty(geo["du_part"], **f32)
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.empty((h, dh), **f32)
    _build.launch("wkv", "repro_wkv_bwd", r, k, v, w, u, dout, states, dv_part, du_part,
                  dr, dk, dv, dw, du, b, s, h, dh)
    _build.LAUNCHES["wkv_bwd"] += 1
    return dr, dk, dv, dw, du


class _Wkv(torch.autograd.Function):
    """wkv_chunked with its backward kernel; the final state is an output
    that carries no gradient (the prefill's cache)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        out, state = wkv_chunked(r, k, v, w, u)
        ctx.save_for_backward(r, k, v, w, u)
        ctx.mark_non_differentiable(state)
        return out, state

    @staticmethod
    def backward(ctx, dout, _dstate):
        return wkv_bwd(*ctx.saved_tensors, dout.contiguous())


def wkv_train(r, k, v, w, u) -> Tuple[torch.Tensor, torch.Tensor]:
    """wkv_chunked's (out, final state), the output differentiable through
    the backward kernel (its plain version on CPU tensors)."""
    return _Wkv.apply(r, k, v, w, u)

"""Wrapper of the flash-attention kernels (csrc/flash_attention.cu):
`flash_attention`, twin of repro.kernels.flash_attention.ops.

The numerical contract is the TPU kernel's: q, k, v in one dtype (bf16 or
fp32), fp32 scores, softmax and accumulation, the output in q's dtype.  The
layout is the JAX package's, q (B, Sq, Hq, dh) and k, v (B, Skv, Hkv, dh).
The kernels mask the ragged edges of Sq and Skv themselves, so nothing is
padded, and a non-causal call with any Skv is exact (the JAX wrapper refuses
that call only because its padding would enter the softmax).  As in the JAX
op, query row i sits at position i.

Two kernels serve the call, chosen by `ROUTES`, an explicit table of
(dtype, head dim) -> kernel; a pair not in it raises:

  "tc"   bf16 at dh 64 and 128 (every full dense config's heads): both
         products on the tensor cores (wgmma).  P is rounded to bf16 before
         P V, which the TPU kernel and the plain version do not do; O and
         the row sums stay fp32.
  "fma"  fp32 at every head dim (1e-5 parity with the plain version), and
         bf16 at dh 80 (the smoke config's heads, which do not fill the tc
         kernel's 128-byte rows): fp32 FMA on the CUDA cores.

`_build.LAUNCHES["flash_attention"]` counts every forward launch, and
`_build.LAUNCHES["flash_attention_tc"]` the tensor-core ones among them.

Training (`flash_attention_train`, a torch.autograd.Function): the forward
is the same launch with an LSE buffer, into which the kernel also writes
each row's log-sum-exp (B, Hq, Sq) fp32; the output is the same bits as
without it.  The backward, `flash_attention_bwd`, is one C entry of three
launches (D = rowsum(dO o O), then dK/dV, then dQ), chosen by `BWD_ROUTES`,
its own (dtype, head dim) table; a pair not in it raises:

  "tc"   bf16 at dh 64 and 128: dK/dV and dQ on wgmma (csrc/flash_attention.cu
         namespace tc, dkdv_tc_kernel and dq_tc_kernel).  P and dS enter
         their products as two bf16 halves each (hi + lo), so the gradient
         stays within twice the plain bf16 version's own rounding.  Bound
         by the tensor cores' rate (0.0408 ms at smollm's training shape,
         B=8, S=1024, 15/5 heads of 64); 0.3181 ms there on an H100 (SDPA's
         backward 0.2143; the FMA route 3.2573 before; chip_smoke phase 12).
  "fma"  fp32 at every head dim and bf16 at dh 80: fp32 FMA on the CUDA
         cores (namespace bwd).

`_build.LAUNCHES["flash_attention_bwd"]` counts every backward call, and
`_build.LAUNCHES["flash_attention_bwd_tc"]` the tensor-core ones among them.
The route is the table's: nothing falls back from one kernel to the other.

A CPU tensor runs the plain versions (ref.py); a CUDA tensor launches a
kernel or raises.  There is no fallback between them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref, attention_lse_ref,
                                                     attention_ref)

__all__ = ["flash_attention", "flash_attention_bwd", "flash_attention_train", "HEAD_DIMS",
           "ROUTES", "BWD_ROUTES", "route", "bwd_route"]

HEAD_DIMS = (64, 80, 128)    # the dh values of the configs' attention heads

# (dtype, head dim) -> the kernel that runs it; _SYMBOLS names its C entry.
ROUTES = {
    (torch.bfloat16, 64): "tc",
    (torch.bfloat16, 128): "tc",
    (torch.bfloat16, 80): "fma",
    (torch.float32, 64): "fma",
    (torch.float32, 80): "fma",
    (torch.float32, 128): "fma",
}
_SYMBOLS = {"tc": "repro_flash_attention_tc", "fma": "repro_flash_attention"}
# (dtype, head dim) -> the backward kernel that runs it; _BWD_SYMBOLS names its C entry.
BWD_ROUTES = {
    (torch.bfloat16, 64): "tc",
    (torch.bfloat16, 128): "tc",
    (torch.bfloat16, 80): "fma",
    (torch.float32, 64): "fma",
    (torch.float32, 80): "fma",
    (torch.float32, 128): "fma",
}
_BWD_SYMBOLS = {"tc": "repro_flash_attention_bwd_tc", "fma": "repro_flash_attention_bwd"}


def _lookup(op: str, table: dict, dtype: torch.dtype, dh: int) -> str:
    try:
        return table[(dtype, dh)]
    except KeyError:
        raise ValueError(f"{op}: head dim {dh} in {dtype} not in "
                         f"the kernels' table {sorted((str(t), d) for t, d in table)} "
                         f"(head dims {HEAD_DIMS})") from None


def route(dtype: torch.dtype, dh: int) -> str:
    """The kernel ("tc" or "fma") that runs (dtype, dh); raises for a pair
    outside ROUTES."""
    return _lookup("flash_attention", ROUTES, dtype, dh)


def bwd_route(dtype: torch.dtype, dh: int) -> str:
    """The backward kernel ("tc" or "fma") that runs (dtype, dh); raises for
    a pair outside BWD_ROUTES."""
    return _lookup("flash_attention_bwd", BWD_ROUTES, dtype, dh)


def check_lm_operands(op: str, tensors) -> bool:
    """Raise unless the (name, tensor) pairs are contiguous CUDA tensors of
    one dtype, bf16 or fp32, each 16-byte aligned; True for bf16."""
    dtypes = {t.dtype for _, t in tensors}
    for name, t in tensors:
        _build.check_cuda_tensor(f"{op}: {name}", t)
        if t.data_ptr() % 16:
            raise ValueError(f"{op}: {name} is not 16-byte aligned")
    if len(dtypes) != 1 or not dtypes <= {torch.float32, torch.bfloat16}:
        raise TypeError(f"{op}: expected operands all bf16 or all fp32, got "
                        f"{sorted(map(str, dtypes))}")
    return dtypes == {torch.bfloat16}


def _check_shapes(op: str, q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{op}: expected q (B,Sq,Hq,dh) and k, v "
                         f"(B,Skv,Hkv,dh), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, hq, dh = q.shape
    _, skv, hkv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != dh or hq % hkv:
        raise ValueError(f"{op}: q {tuple(q.shape)} does not fit "
                         f"k, v {tuple(k.shape)}")
    if min(b, sq, skv) == 0 and q.device.type == "cuda":
        raise ValueError(f"{op}: empty operand {tuple(q.shape)}, {tuple(k.shape)}")


def _forward(q, k, v, causal: bool, window: int, lse: Optional[torch.Tensor]):
    """The forward launch on CUDA tensors; `lse` None (serving) or a
    (B, Hq, Sq) fp32 buffer the kernel fills (training)."""
    b, sq, hq, dh = q.shape
    _, skv, hkv, _ = k.shape
    bf16 = check_lm_operands("flash_attention", (("q", q), ("k", k), ("v", v)))
    kernel = route(q.dtype, dh)
    out = torch.empty_like(q)
    dtype_flag = () if kernel == "tc" else (int(bf16),)
    _build.launch("flash_attention", _SYMBOLS[kernel], q, k, v, out, lse, *dtype_flag,
                  b, sq, skv, hq, hkv, dh, int(causal), int(window), dh ** -0.5)
    _build.LAUNCHES["flash_attention"] += 1
    if kernel == "tc":
        _build.LAUNCHES["flash_attention_tc"] += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0) -> torch.Tensor:
    """GQA attention: q (B,Sq,Hq,dh), k,v (B,Skv,Hkv,dh), Hq % Hkv == 0 ->
    (B,Sq,Hq,dh) in q's dtype.  `window` > 0 limits lookback."""
    _check_shapes("flash_attention", q, k, v)
    if _build.on_cpu(q, "flash_attention"):
        return attention_ref(q, k, v, causal=causal, window=window)
    return _forward(q, k, v, causal, window, None)


def flash_attention_lse(q, k, v, *, causal: bool = True,
                        window: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(flash_attention's output, the same bits, and each row's log-sum-exp
    (B, Hq, Sq) fp32): the training forward."""
    _check_shapes("flash_attention", q, k, v)
    if _build.on_cpu(q, "flash_attention"):
        return attention_lse_ref(q, k, v, causal=causal, window=window)
    b, sq, hq, _ = q.shape
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    return _forward(q, k, v, causal, window, lse), lse


def flash_attention_bwd(q, k, v, o, do, lse, *, causal: bool = True,
                        window: int = 0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of flash_attention at (q, k, v) against the output's
    gradient `do`, from the forward's output `o` and `lse`; in the inputs'
    dtype, accumulated in fp32."""
    _check_shapes("flash_attention_bwd", q, k, v)
    b, sq, hq, dh = q.shape
    _, skv, hkv, _ = k.shape
    if o.shape != q.shape or do.shape != q.shape or tuple(lse.shape) != (b, hq, sq):
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)}, do {tuple(do.shape)} "
                         f"and lse {tuple(lse.shape)} do not fit q {tuple(q.shape)}")
    if _build.on_cpu(q, "flash_attention_bwd"):
        return attention_bwd_ref(q, k, v, o, do, lse, causal=causal, window=window)
    bf16 = check_lm_operands("flash_attention_bwd", (("q", q), ("k", k), ("v", v),
                                                     ("o", o), ("do", do)))
    kernel = bwd_route(q.dtype, dh)
    _build.check_cuda_tensor("flash_attention_bwd: lse", lse, (b, hq, sq))
    if lse.dtype != torch.float32:
        raise TypeError(f"flash_attention_bwd: lse must be fp32, got {lse.dtype}")
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dtype_flag = () if kernel == "tc" else (int(bf16),)
    _build.launch("flash_attention", _BWD_SYMBOLS[kernel], q, k, v, o, do, lse, delta,
                  dq, dk, dv, *dtype_flag, b, sq, skv, hq, hkv, dh, int(causal), int(window),
                  dh ** -0.5)
    _build.LAUNCHES["flash_attention_bwd"] += 1
    if kernel == "tc":
        _build.LAUNCHES["flash_attention_bwd_tc"] += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """flash_attention with its backward kernel: the forward saves q, k, v,
    the output and the rows' log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out, lse = flash_attention_lse(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do.contiguous(), lse,
                                         causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention_train(q, k, v, *, causal: bool = True, window: int = 0) -> torch.Tensor:
    """flash_attention, differentiable through the backward kernel (its
    plain version on CPU tensors)."""
    return _FlashAttention.apply(q, k, v, causal, window)

"""Mamba-1 selective SSM mixer (twin of repro.models.mamba), Jamba's
recurrent layer.

The diagonal A makes the recurrence h_t = a_t * h_{t-1} + b_t element-wise,
so the full-sequence pass is a scan over the sequence axis with the combine
(a_l, b_l) . (a_r, b_r) = (a_l * a_r, b_l * a_r + b_r).  The port has no
jax.lax.associative_scan: `scan` is a log-depth (Hillis-Steele) scan on
tensors, its levels updating the two fp32 operands in place; its tree order
is not jax's, so the two agree to fp32 rounding, not bit for bit.  With
cfg.mamba_chunk dividing S the scan runs chunk by chunk, carrying the
(B, di, n) state, as in the JAX package.  Under autograd (training) the
scan is `_SelectiveScan`, whose backward is the same scan run in reverse:
it saves abar and h, where autograd of the log-depth scan would keep two
(B, S, di, n) tensors a level (the JAX package differentiates its
associative_scan by autodiff).  The depthwise causal conv is
d_conv shifted adds.  The selective scan is plain PyTorch on both devices:
the JAX package computes it outside any Pallas kernel.

dtype flow, as in the JAX package: in_proj, the conv and x_proj in the
compute dtype; dt, B, C, the discretised a and b, the state h and y in fp32;
y cast to x's dtype before the gate.  The decode cache holds h (B, di, n) and
the last d_conv - 1 conv inputs (B, d_conv - 1, di), both fp32, so a decode
step's conv (and x_proj product) runs in fp32 where the prefill's ran in
the compute dtype.

`mamba_apply` also returns the final state when asked (prefill's cache: the
last h and the last d_conv - 1 conv inputs in fp32), where the JAX package's
transformer._mamba_final_state replays the unchunked scan for it.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

__all__ = ["mamba_init", "mamba_apply", "mamba_decode", "mamba_cache_shape", "scan"]


def _dims(cfg):
    di = cfg.mamba_expand * cfg.d_model
    return di, cfg.mamba_d_state, cfg.mamba_d_conv, cfg.dt_rank


def mamba_init(gen: torch.Generator, cfg) -> dict:
    """S4D-real A (a_log = log(1..n) per channel), dt_bias the inverse
    softplus of a log-uniform draw on [1e-3, 1e-1], d_skip ones."""
    d = cfg.d_model
    di, n, kconv, rank = _dims(cfg)
    dt = cfg.pdtype()
    dev = gen.device
    a_init = torch.arange(1, n + 1, dtype=torch.float32, device=dev).expand(di, n)
    u = torch.rand((di,), generator=gen, dtype=torch.float32, device=dev)
    log_dt = math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3))
    return {
        "in_proj": L.dense_init(gen, (d, 2 * di), dt),
        "conv_w": (torch.randn((kconv, di), generator=gen, dtype=torch.float32, device=dev)
                   * (1.0 / kconv)).to(dt),
        "conv_b": torch.zeros((di,), dtype=dt, device=dev),
        "x_proj": L.dense_init(gen, (di, rank + 2 * n), dt),
        "dt_proj": L.dense_init(gen, (rank, di), dt, scale=rank**-0.5),
        "dt_bias": torch.log(torch.expm1(torch.exp(log_dt))),
        "a_log": torch.log(a_init).contiguous(),
        "d_skip": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": L.dense_init(gen, (di, d), dt),
    }


def _matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w in their promoted dtype (jnp's mixed-dtype matmul)."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return a.to(dt) @ w.to(dt)


def _ssm_inputs(p, xc: torch.Tensor, cfg):
    """xc: (..., di) post-conv activations -> (dt, B, C) selective params."""
    _, n, _, rank = _dims(cfg)
    proj = _matmul(xc, p["x_proj"])
    dt_in, b_in, c_in = torch.split(proj, [rank, n, n], dim=-1)
    dt = F.softplus(dt_in.float() @ p["dt_proj"].float() + p["dt_bias"])    # (..., di)
    return dt, b_in.float(), c_in.float()


def _conv_shifts(p, xin: torch.Tensor, kconv: int) -> torch.Tensor:
    """Causal depthwise conv via shifted adds; xin: (B, S, di)."""
    s = xin.shape[1]
    out = xin * p["conv_w"][kconv - 1]
    for j in range(kconv - 1):
        shift = kconv - 1 - j
        shifted = F.pad(xin, (0, 0, shift, 0))[:, :s]
        out = out + shifted * p["conv_w"][j]
    return F.silu(out + p["conv_b"])


def scan(a: torch.Tensor, b: torch.Tensor, dim: int = 1,
         reverse: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of h_t = a_t * h_{t-1} + b_t along `dim` from h = 0:
    returns (the products of a up to t, h_t); with `reverse`, of h_t = a_t *
    h_{t+1} + b_t from the end (the products of a from t on).  Log depth: at
    offset o every position takes the combine of itself and the position o
    before it (o after it, reversed).  Without autograd `a` and `b` are
    overwritten (the results are them), one level's temporary at a time;
    under autograd (forward only: _SelectiveScan's backward runs the
    reverse scan without it) each level makes new tensors."""
    n = a.shape[dim]
    in_place = not L.needs_grad(a, b)
    if reverse and not in_place:
        raise ValueError("mamba.scan: the reverse scan runs without autograd")
    o = 1
    while o < n:
        lo_a, hi_a = a.narrow(dim, 0, n - o), a.narrow(dim, o, n - o)
        lo_b, hi_b = b.narrow(dim, 0, n - o), b.narrow(dim, o, n - o)
        src_a, dst_a, src_b, dst_b = (hi_a, lo_a, hi_b, lo_b) if reverse else (
            lo_a, hi_a, lo_b, hi_b)
        if in_place:
            dst_b += src_b * dst_a
            dst_a.copy_(src_a * dst_a)
        else:
            b = torch.cat([b.narrow(dim, 0, o), src_b * dst_a + dst_b], dim)
            a = torch.cat([a.narrow(dim, 0, o), src_a * dst_a], dim)
        o *= 2
    return a, b


def _scan_states(abar: torch.Tensor, bx: torch.Tensor, chunk: int,
                 reverse: bool = False) -> torch.Tensor:
    """h over the sequence (B, S, di, n), in bx's storage (both operands are
    overwritten; no autograd): one scan, or chunk by chunk with the boundary
    state carried (from the last chunk back, reversed) when `chunk` divides
    S (and is shorter)."""
    s = abar.shape[1]
    if not (chunk and s % chunk == 0 and s > chunk):
        return scan(abar, bx, reverse=reverse)[1]
    carry = torch.zeros_like(abar[:, 0])
    starts = range(0, s, chunk)
    for c0 in (reversed(starts) if reverse else starts):
        af, bf = scan(abar[:, c0:c0 + chunk], bx[:, c0:c0 + chunk], reverse=reverse)
        bf.copy_(af * carry[:, None] + bf)                          # carry in
        carry = bf[:, 0] if reverse else bf[:, -1]
    return bx


class _SelectiveScan(torch.autograd.Function):
    """h = _scan_states(abar, bx, chunk) under autograd, differentiated by
    the reverse recurrence: with g = dL/dh, lam_t = g_t + abar_{t+1} lam_{t+1}
    (lam after the last position 0), dL/dbx = lam and dL/dabar_t = lam_t *
    h_{t-1} (h_{-1} = 0).  The forward is the in-place scan on copies of its
    inputs (the same bits as without autograd) and saves abar and h only;
    the backward is the same scan reversed, in place: besides those two it
    holds g, lam and one scratch (B, S, di, n) tensor, where autograd of the
    log-depth scan keeps two new tensors a level."""

    @staticmethod
    def forward(ctx, abar, bx, chunk: int):
        h = _scan_states(abar.clone(), bx.clone(), chunk)
        ctx.save_for_backward(abar, h)
        ctx.chunk = chunk
        return h

    @staticmethod
    def backward(ctx, g):
        abar, h = ctx.saved_tensors
        s = abar.shape[1]
        lam = g.clone(memory_format=torch.contiguous_format)
        a = torch.empty_like(abar)                                  # a_t = abar_{t+1}
        a[:, :s - 1] = abar[:, 1:]
        a[:, s - 1] = 0.0
        _scan_states(a, lam, ctx.chunk, reverse=True)
        torch.mul(lam[:, 1:], h[:, :s - 1], out=a[:, 1:])          # dabar, in a's storage
        a[:, 0] = 0.0
        return a, lam, None


def mamba_apply(p: dict, x: torch.Tensor, cfg, final_state: bool = False):
    """Full-sequence train/prefill path. x: (B, S, D) -> (B, S, D), and with
    `final_state` also the decode cache after the last token ({"h", "conv"})."""
    _, _, kconv, _ = _dims(cfg)
    xin, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)
    xc = _conv_shifts(p, xin, kconv)

    dt, b_in, c_in = _ssm_inputs(p, xc, cfg)
    a = -torch.exp(p["a_log"])                                        # (di, n)
    # discretise: abar = exp(dt * A) (diagonal), bbar * x = dt * B * x
    abar = torch.exp(dt[..., None] * a)                               # (B,S,di,n)
    bx = (dt * xc.float())[..., None] * b_in[:, :, None, :]           # (B,S,di,n)
    if L.needs_grad(abar, bx):
        h = _SelectiveScan.apply(abar, bx, cfg.mamba_chunk)
    else:
        h = _scan_states(abar, bx, cfg.mamba_chunk)
    del abar, bx
    y = (h @ c_in[..., None])[..., 0] + p["d_skip"] * xc.float()
    y = y.to(x.dtype) * F.silu(z)
    out = y @ p["out_proj"]
    if not final_state:
        return out
    return out, {"h": h[:, -1].clone(), "conv": xin[:, -(kconv - 1):].float()}


def mamba_cache_shape(cfg, batch: int) -> Dict[str, tuple]:
    di, n, kconv, _ = _dims(cfg)
    return {
        "h": (batch, di, n),       # fp32 SSM state
        "conv": (batch, kconv - 1, di),
    }


def mamba_decode(p: dict, x: torch.Tensor, cache: dict, cfg) -> Tuple[torch.Tensor, dict]:
    """One-token step. x: (B, 1, D); cache per mamba_cache_shape (fp32)."""
    xin, z = torch.chunk(x[:, 0] @ p["in_proj"], 2, dim=-1)          # (B, di)
    conv_buf = torch.cat([cache["conv"], xin[:, None]], dim=1)       # the fp32 cache promotes
    cdt = torch.promote_types(conv_buf.dtype, p["conv_w"].dtype)
    xc = torch.einsum("bkd,kd->bd", conv_buf.to(cdt), p["conv_w"].to(cdt))
    xc = F.silu(xc + p["conv_b"])

    dt, b_in, c_in = _ssm_inputs(p, xc, cfg)                          # (B,di),(B,n),(B,n)
    a = -torch.exp(p["a_log"])
    abar = torch.exp(dt[..., None] * a)                               # (B,di,n)
    bx = (dt * xc.float())[..., None] * b_in[:, None, :]
    h = cache["h"] * abar + bx
    y = (h @ c_in[..., None])[..., 0] + p["d_skip"] * xc.float()
    y = y.to(x.dtype) * F.silu(z)
    out = (y @ p["out_proj"])[:, None]
    return out, {"h": h, "conv": conv_buf[:, 1:]}

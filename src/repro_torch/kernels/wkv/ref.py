"""Plain PyTorch versions of the WKV kernel (fp32 contract).

`wkv_ref` is the twin of repro.kernels.wkv.ref.wkv_ref, the sequential
RWKV-6 recurrence, and also returns the final state (B, H, dh, dh), which
the CUDA kernel writes too; it is the CPU path of kernels.wkv.ops and the
yardstick of the kernel on the card.  `wkv_safe_chunked_ref` spells out the
CUDA kernel's algorithm: chunks of c tokens whose decay factors are running
products of w inside the chunk, never quotients, so that they can underflow
but not overflow.  `wkv_chunked_ref` is the twin of the JAX package's
chunked linear-attention form (repro.models.rwkv._wkv_chunked), which that
model takes for configs with rwkv_chunk > 0; like its twin it divides by the
within-chunk cumulative decay, whose exp(-log P) overflows fp32 once a
chunk's summed log-decay passes about -88.  The port routes neither chunked
form; they hold the kernel's algorithm and the port's recurrence to the JAX
package.

`wkv_bwd_ref` is the closed-form gradient of the recurrence, token by
token (the JAX package has no backward kernel; its training differentiates
the plain scan, and tests hold this against jax.grad of wkv_ref): the CPU
path of kernels.wkv.ops.wkv_bwd and the backward kernel's yardstick on the
card.  `wkv_bwd_chunked_ref` spells out the backward kernel's algorithm:
chunks walked from the last, dL/dS carried across them, per-row recursions
whose decay factors are products of w, never quotients.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["wkv_ref", "wkv_safe_chunked_ref", "wkv_chunked_ref", "wkv_bwd_ref",
           "wkv_bwd_chunked_ref"]


def wkv_ref(r, k, v, w, u) -> Tuple[torch.Tensor, torch.Tensor]:
    """r,k,v,w: (B,S,H,dh) fp32 (w in (0,1)); u: (H,dh) ->
    (out (B,S,H,dh), final state (B,H,dh,dh)).

        out_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
        S_t   = diag(w_t) S_{t-1} + k_t v_t^T
    """
    b, s, h, dh = r.shape
    state = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=r.device)
    outs = []
    for t in range(s):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]
        kv = kt[..., :, None] * vt[..., None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", rt, state + u[None, :, :, None] * kv))
        state = wt[..., :, None] * state + kv
    out = torch.stack(outs, dim=1) if outs else torch.zeros_like(r)
    return out, state


def _running(wc, reverse=False):
    """Exclusive running products of wc (B,n,H,dh) along its token axis,
    from the first token (or down from the last): prod_{u<t} w_u (prod_{u>t})."""
    n = wc.shape[1]
    run, out = torch.ones_like(wc[:, 0]), [None] * n
    for t in (range(n - 1, -1, -1) if reverse else range(n)):
        out[t] = run
        run = run * wc[:, t]
    return torch.stack(out, dim=1), run


def _safe_scores(rc, kc, wc, u, m: int) -> torch.Tensor:
    """The chunk's scores A (B,H,n,n) of wkv_safe_chunked_ref from its r, k, w
    (B,n,H,dh) and u (H,dh): A[t, t] = sum_i r_t u k_t, A[t, s] (s < t) =
    sum_i r_t k_s prod_{s<u<t} w_u by running products inside the halves of
    m tokens and through the midpoint across them, the strict upper triangle
    zero; no product of w is divided by another."""
    b, n, h, _ = rc.shape
    a = torch.zeros((b, h, n, n), dtype=torch.float32, device=rc.device)
    idx = torch.arange(n, dtype=torch.int64, device=rc.device)
    a[:, :, idx, idx] = (rc * u * kc).sum(-1).transpose(1, 2)
    for lo in range(0, n, m):                                        # inside the halves
        hi = min(lo + m, n)
        hcur = rc[:, lo:hi].clone()                                  # lag t - s = 1
        for d in range(1, hi - lo):
            a[:, :, idx[lo + d:hi], idx[lo:hi - d]] = (
                (hcur[:, d:] * kc[:, lo:hi - d]).sum(-1).transpose(1, 2))
            hcur[:, d:] = hcur[:, d:] * wc[:, lo:hi - d]
    if n > m:                                                        # across them
        r8 = rc[:, m:] * _running(wc[:, m:])[0]
        k8 = kc[:, :m] * _running(wc[:, :m], reverse=True)[0]
        a[:, :, m:, :m] = torch.einsum("bthd,bshd->bhts", r8, k8)
    return a


def wkv_safe_chunked_ref(r, k, v, w, u, c: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel's overflow-safe chunked WKV, in its order of
    operations: r/k/v/w (B,S,H,dh) fp32, u (H,dh), any S >= 1 (the last
    chunk may be short), c even -> (out (B,S,H,dh), final state (B,H,dh,dh)).

    Per chunk of n <= c tokens, with every product of w's taken inside it
    and none divided by another:
        Pex_t = prod_{u<t} w_u,  Sfx_s = prod_{u>s} w_u,  Pall = prod_u w_u
        A[t, t] = sum_i r_t u k_t (the bonus)
        A[t, s] = sum_i h k_s, h = r_t prod_{s<u<t} w_u walked from s = t-1
                  down, for s < t in the same half of the chunk,
                = sum_i (r_t prod_{m<=u<t} w_u)(k_s prod_{s<u<m} w_u) across
                  the halves (t >= m = c/2 > s)
        out_t   = (r_t Pex_t)^T S + sum_{s<=t} A[t, s] v_s
        S       <- diag(Pall) S + sum_s (k_s Sfx_s) v_s^T
    """
    b, s, h, dh = r.shape
    m = c // 2
    state = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=r.device)
    outs = []
    for t0 in range(0, s, c):
        rc, kc, vc, wc = (x[:, t0:t0 + c] for x in (r, k, v, w))      # (B,n,H,dh)
        n = rc.shape[1]
        pex, pall = _running(wc)
        sfx, _ = _running(wc, reverse=True)
        a = _safe_scores(rc, kc, wc, u, m)
        outs.append(torch.einsum("bthk,bhkv->bthv", rc * pex, state)
                    + torch.einsum("bhts,bshv->bthv", a, vc))
        state = pall[..., None] * state + torch.einsum("bshk,bshv->bhkv", kc * sfx, vc)
    return torch.cat(outs, dim=1), state


def wkv_chunked_ref(r, k, v, w, u, c: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV: r/k/v/w (B,S,H,dh) fp32, u (H,dh), S % c == 0 ->
    (out (B,S,H,dh), final state (B,H,dh,dh)); the same function as
    `wkv_ref` in another summation order."""
    b, s, h, dh = r.shape
    n = s // c
    state = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=r.device)
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device), diagonal=-1)
    outs = []
    for i in range(n):
        sl = slice(i * c, (i + 1) * c)
        rch, kch, vch, wch = r[:, sl], k[:, sl], v[:, sl], w[:, sl]   # (B,C,H,dh)
        logw = torch.log(torch.clamp(wch, min=1e-38))
        lp = torch.cumsum(logw, dim=1)                               # log P_t (inclusive)
        lp_prev = lp - logw                                          # log P_{t-1}
        r_t = rch * torch.exp(lp_prev)                               # r_t * P_{t-1}
        k_s = kch * torch.exp(-lp)                                   # k_s / P_s
        scores = torch.einsum("bthd,bshd->bhts", r_t, k_s)           # (B,H,C,C)
        scores = torch.where(mask[None, None], scores, 0.0)
        out = torch.einsum("bhts,bshd->bthd", scores, vch)           # (B,C,H,dh)
        bonus = torch.einsum("bthd,bthd->bth", rch * u[None, None], kch)
        out = out + bonus[..., None] * vch
        out = out + torch.einsum("bthk,bhkv->bthv", r_t, state)
        lp_end = lp[:, -1:]                                          # (B,1,H,dh)
        k_end = kch * torch.exp(lp_end - lp)                         # k_s * P_C/P_s
        state = (torch.exp(lp_end[:, 0])[..., None] * state
                 + torch.einsum("bshk,bshv->bhkv", k_end, vch))
        outs.append(out)
    return torch.cat(outs, dim=1), state


def wkv_bwd_ref(r, k, v, w, u, dout) -> Tuple[torch.Tensor, ...]:
    """The gradient of wkv_ref's output at (r, k, v, w, u) against its
    gradient `dout` (B,S,H,dh), in closed form (not autograd): the
    recurrence's reverse form, with G_t = dL/dS_t (G_{S-1} = 0), g_t = dout_t,
    a_t = v_t . g_t and b_t = sum_i r_t[i] u[i] k_t[i],
        dr_t = S_{t-1} g_t + u k_t a_t,    dk_t = G_t v_t + r_t u a_t,
        dv_t = G_t^T k_t + g_t b_t,        dw_t = rowsum(G_t o S_{t-1}),
        du   = sum_b sum_t r_t k_t a_t,    G_{t-1} = diag(w_t) G_t + r_t g_t^T,
    S_{t-1} from a forward pass (never divided out of S_t) ->
    (dr, dk, dv, dw (B,S,H,dh), du (H,dh)), fp32."""
    b, s, h, dh = r.shape
    prev = []                                   # S_{t-1} for every t
    state = torch.zeros((b, h, dh, dh), dtype=r.dtype, device=r.device)
    for t in range(s):
        prev.append(state)
        state = w[:, t][..., :, None] * state + k[:, t][..., :, None] * v[:, t][..., None, :]
    grads = [torch.empty_like(r) for _ in range(4)]
    dr, dk, dv, dw = grads
    du = torch.zeros_like(u)
    gstate = torch.zeros_like(state)
    for t in range(s - 1, -1, -1):
        rt, kt, vt, wt, gt = r[:, t], k[:, t], v[:, t], w[:, t], dout[:, t]
        a = (vt * gt).sum(-1, keepdim=True)                          # (B,H,1)
        bonus = (rt * u * kt).sum(-1, keepdim=True)
        dr[:, t] = torch.einsum("bhij,bhj->bhi", prev[t], gt) + u * kt * a
        dk[:, t] = torch.einsum("bhij,bhj->bhi", gstate, vt) + rt * u * a
        dv[:, t] = torch.einsum("bhij,bhi->bhj", gstate, kt) + gt * bonus
        dw[:, t] = (gstate * prev[t]).sum(-1)
        du = du + (rt * kt * a).sum(0)
        gstate = wt[..., :, None] * gstate + rt[..., :, None] * gt[..., None, :]
    return dr, dk, dv, dw, du


def wkv_bwd_chunked_ref(r, k, v, w, u, dout, c: int = 16,
                        rows: int = 32) -> Tuple[torch.Tensor, ...]:
    """The backward kernel's algorithm (csrc/wkv.cu namespace wkvb), in its
    order of operations: the gradient of wkv_ref's output against `dout`,
    as wkv_bwd_ref gives it, from chunks of c tokens walked from the last,
    with every decay factor a product of w's and none divided by another.

    A first pass saves the state S0 at every chunk's start.  Per chunk of
    n <= c tokens (tokens past n count as r = k = v = g = 0, w = 1), with
    G_end = dL/dS after its last token (0 after the sequence), and per block
    of `rows` key rows i (a CUDA block's slice; every quantity below but the
    scores and dv is per row):
        B[t, s] = g_t . v_s,  a_t = B[t, t],  X = g S0^T,  Y = v G_end^T,
        c0 = rowsum(G_end o S0),  rP = r Pex,  kS = k Sfx,  A = the rows'
        share of the forward's scores (_safe_scores, bonus on the diagonal);
        dv      = sum over row blocks, in order, of kS G_end + A^T g;
        G_start = diag(Pall) G_end + rP^T g;
    and per row i two recursions over t = 0 .. n-1, Q[s] (from X[s]) and
    Z (from c0), with an upward walk h = prod_{t<u<s} w_u:
        dr_t = Q[t] + u k_t a_t,
        dk_t = Sfx_t Y_t + sum_{s>t} h r_s B[s, t] + r_t u a_t,
        dw_t = Sfx_t Z + sum_{s>t} h r_s Q[s],
        then Z <- w_t Z + k_t Y_t,  Q[s] <- w_t Q[s] + k_t B[s, t] (s > t);
    Sfx_t is the walk's last h.  Q[s] holds Pex_t X_s plus the chunk's own
    states' share of dr_s, Z the boundary and in-chunk share of dw's
    sum_j G_t[i, j] S_{t-1}[i, j] with the factor w_t left out: no quotient.
    -> (dr, dk, dv, dw (B,S,H,dh), du (H,dh)), fp32."""
    b, s, h, dh = r.shape
    m = c // 2
    z4 = dict(dtype=torch.float32, device=r.device)
    starts = []                                          # S0 of every chunk
    state = torch.zeros((b, h, dh, dh), **z4)
    for t0 in range(0, s, c):
        starts.append(state)
        kc, vc, wc = (x[:, t0:t0 + c] for x in (k, v, w))
        sfx, pall = _running(wc, reverse=True)
        state = pall[..., None] * state + torch.einsum("bshk,bshv->bhkv", kc * sfx, vc)
    dr, dk, dv, dw = (torch.zeros_like(r) for _ in range(4))
    du = torch.zeros_like(u)
    gstate = torch.zeros((b, h, dh, dh), **z4)
    for ci in range(len(starts) - 1, -1, -1):
        t0 = ci * c
        n = min(c, s - t0)
        rc, kc, vc, wc, gc = (x[:, t0:t0 + n] for x in (r, k, v, w, dout))
        if n < c:                                        # the masked tail of the kernel
            tail = torch.zeros((b, c - n, h, dh), **z4)
            rc, kc, vc, gc = (torch.cat([x, tail], dim=1) for x in (rc, kc, vc, gc))
            wc = torch.cat([wc, tail + 1.0], dim=1)
        s0 = starts[ci]
        pex, pall = _running(wc)
        sfx, _ = _running(wc, reverse=True)
        bm = torch.einsum("bthj,bshj->bhts", gc, vc)     # B[t, s] = g_t . v_s
        x_ = torch.einsum("bthj,bhij->bthi", gc, s0)     # X[t, i]
        y_ = torch.einsum("bthj,bhij->bthi", vc, gstate)  # Y[t, i]
        c0 = (gstate * s0).sum(-1)                       # (B,H,dh)
        dvc = torch.zeros_like(vc)
        for i0 in range(0, dh, rows):                    # the row blocks, in order
            sl = slice(i0, i0 + rows)
            a = _safe_scores(rc[..., sl], kc[..., sl], wc[..., sl], u[:, sl], m)
            dvc = dvc + (torch.einsum("bthi,bhij->bthj", (kc * sfx)[..., sl], gstate[:, :, sl])
                         + torch.einsum("bhst,bshj->bthj", a, gc))
        at = torch.diagonal(bm, dim1=-2, dim2=-1).transpose(1, 2)[..., None]   # (B,c,H,1)
        q = [x_[:, t] for t in range(c)]                 # Q[s], (B,H,dh) each
        z = c0
        for t in range(c):
            hh = torch.ones_like(z)
            ak = torch.zeros_like(z)
            aw = torch.zeros_like(z)
            for s_ in range(t + 1, c):
                hr = hh * rc[:, s_]
                ak = ak + hr * bm[:, :, s_, t][..., None]
                aw = aw + hr * q[s_]
                hh = hh * wc[:, s_]
            if t < n:
                dr[:, t0 + t] = q[t] + u * kc[:, t] * at[:, t]
                dk[:, t0 + t] = hh * y_[:, t] + ak + rc[:, t] * u * at[:, t]
                dw[:, t0 + t] = hh * z + aw
                du = du + (rc[:, t] * kc[:, t] * at[:, t]).sum(0)
            z = wc[:, t] * z + kc[:, t] * y_[:, t]
            for s_ in range(t + 1, c):
                q[s_] = wc[:, t] * q[s_] + kc[:, t] * bm[:, :, s_, t][..., None]
        dv[:, t0:t0 + n] = dvc[:, :n]
        gstate = pall[..., None] * gstate + torch.einsum("bthi,bthj->bhij", rc * pex, gc)
    return dr, dk, dv, dw, du

"""The C library's float32 sine, cosine and arctangent, bit for bit, in
PyTorch.

XLA's CPU code calls the C library's `sinf` and `cosf` for a float32
`jnp.sin` / `jnp.cos` (and `atan2f(x, 1)`, which is `atanf(x)`, for
`jnp.arctan`), so the JAX package's float32 Friedman-1/3 and cosine
outcomes and its random-Fourier-feature agents carry glibc's roundings.
glibc (2.28 on) computes both in double precision: a reduction to
[-pi/4, pi/4] and a quadrant n, then an even or odd polynomial in the
reduced argument, rounded to float32 once at the end.  x86_64 builds the
same source with FMA contraction and picks that build on a CPU with FMA
(every multiply-add of the polynomials and of the short reduction is one
fused operation).  This module writes those steps as float64 tensor
operations, the fused ones through `prng._fma` (exact on the CPU,
`torch.addcmul` on the card), so the CPU and the card give the C
library's bits:

    |x| < 0.75 (by the top 12 bits)   the polynomial in x itself; |x| <
                                      2^-12 returns x (sin) or 1 (cos)
    |x| < 120                         n = round(x 2/pi) by a scaled
                                      truncation, r = x - n pi/2 fused
    finite                            192 bits of 4/pi as 24 words: a
                                      32 x 96-bit product in 2.62 fixed
                                      point, taken in 32-bit halves here
    inf, nan                          nan

The coefficients and the 4/pi words are glibc's (sysdeps/ieee754/flt-32,
sincosf_data.c).  float64 inputs go to torch.sin / torch.cos: XLA's
float64 sine is its own, within an ulp of either.  `atanf` is fdlibm's,
float32 arithmetic throughout (see there).
"""
from __future__ import annotations

import torch

from repro_torch.prng import _fma

__all__ = ["sin", "cos", "atan", "sqrt", "sinf", "cosf", "atanf"]

_MASK = 0xFFFFFFFF
_HPI_INV = float.fromhex("0x1.45f306dc9c883p+23")     # 2/pi * 2^24
_HPI = float.fromhex("0x1.921fb54442d18p+0")          # pi/2
_PI63 = float.fromhex("0x1.921fb54442d18p-62")        # 2 pi 2^-64
_C = (1.0, float.fromhex("-0x1.ffffffd0c621cp-2"),
      float.fromhex("0x1.55553e1068f19p-5"),
      float.fromhex("-0x1.6c087e89a359dp-10"),
      float.fromhex("0x1.99343027bf8c3p-16"))
_S = (float.fromhex("-0x1.555545995a603p-3"),
      float.fromhex("0x1.1107605230bc4p-7"),
      float.fromhex("-0x1.994eb3774cf24p-13"))
_INV_PIO4 = (
    0xa2, 0xa2f9, 0xa2f983, 0xa2f9836e, 0xf9836e4e, 0x836e4e44, 0x6e4e4415,
    0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757, 0xfc2757d1, 0x2757d1f5,
    0x57d1f534, 0xd1f534dd, 0xf534ddc0, 0x34ddc0db, 0xddc0db62, 0xc0db6295,
    0xdb629599, 0x6295993c, 0x95993c43, 0x993c4390, 0x3c439041)
# the top 12 bits (sign cleared) of 0.75 (glibc's test against pi/4),
# 2^-12, 120 and infinity
_TOP_SMALL, _TOP_TINY, _TOP_FAST, _TOP_INF = 0x3f4, 0x398, 0x42f, 0x7f8


def _mul32(a: torch.Tensor, b: torch.Tensor):
    """The full product of two uint32 values held in int64: (high word,
    low word), through 16-bit halves of a so nothing overflows."""
    lo_part = (a & 0xFFFF) * b                      # < 2^48
    hi_part = (a >> 16) * b                         # < 2^48
    low = lo_part + ((hi_part & 0xFFFF) << 16)
    return (hi_part >> 16) + (low >> 32), low & _MASK


def _reduce_large(xi: torch.Tensor):
    """glibc's reduce_large for the float bits xi (int64, sign ignored):
    (r, n), r = (x mod pi/2) in [-pi/4, pi/4] as a double, n the quadrant
    (0..3)."""
    idx = (xi >> 26) & 15
    shift = (xi >> 23) & 7
    m = (((xi & 0xFFFFFF) | 0x800000) << shift) & _MASK
    table = torch.tensor(_INV_PIO4, dtype=torch.int64, device=xi.device)
    a0, a4, a8 = table[idx], table[idx + 4], table[idx + 8]
    r0 = _mul32(m, a0)[1]                           # uint32 product: low word
    r1_hi, r1_lo = _mul32(m, a4)
    r2_hi = _mul32(m, a8)[0]
    # res0 = (res2 >> 32) | (res0 << 32), then res0 += res1 (mod 2^64)
    lo = r2_hi + r1_lo
    hi = (r0 + r1_hi + (lo >> 32)) & _MASK
    lo = lo & _MASK
    n = ((hi + (1 << 29)) & _MASK) >> 30            # (res0 + 2^61) >> 62
    hi = (hi - (n << 30)) & _MASK
    signed = (hi - ((hi >> 31) << 32)) * (1 << 32) + lo
    return signed.to(torch.float64) * _PI63, n


def _reduce(x: torch.Tensor, xi: torch.Tensor, top: torch.Tensor):
    """(r, n, k) for every element: the fast reduction below 120, the
    large one above.  n is the quadrant that picks the polynomial; k, which
    picks the sign and the table, is n plus the sign bit in the large
    reduction (r is then of |x|), n itself in the fast one."""
    fast = top < _TOP_FAST
    xf = torch.where(fast, x, torch.zeros_like(x))
    t = (xf * _HPI_INV).to(torch.int64)             # C's (int32_t) truncation
    n_fast = (t + 0x800000) >> 24
    r_fast = _fma(-n_fast.to(torch.float64), _HPI, xf)
    r_large, n_large = _reduce_large(xi)
    k_large = n_large + ((xi >> 31) & 1)
    return (torch.where(fast, r_fast, r_large), torch.where(fast, n_fast, n_large),
            torch.where(fast, n_fast, k_large))


def _poly(x: torch.Tensor, x2: torch.Tensor, odd: torch.Tensor,
          negate: torch.Tensor) -> torch.Tensor:
    """glibc's sinf_poly: the sine polynomial where `odd` is False, the
    cosine one (negated where `negate`) where it is True."""
    x3 = x * x2
    s1 = _fma(x2, _S[2], _S[1])
    x7 = x3 * x2
    s = _fma(x3, _S[0], x)
    sin_r = _fma(x7, s1, s)
    sg = torch.where(negate, -1.0, 1.0).to(torch.float64)
    c0, c1, c2, c3, c4 = (sg * c for c in _C)
    x4 = x2 * x2
    cc2 = _fma(x2, c4, c3)
    cc1 = _fma(x2, c1, c0)
    x6 = x4 * x2
    c = _fma(x4, c2, cc1)
    cos_r = _fma(x6, cc2, c)
    return torch.where(odd, cos_r, sin_r)


_CHUNK = 1 << 22


def _chunked(fn, x: torch.Tensor) -> torch.Tensor:
    """fn over chunks of 2^22 elements: each element is computed alone, so
    the bits are the same, and a large input (an rff agent batch's
    features: 10^9 values) never holds tens of float64 temporaries of its
    whole size at once."""
    if x.numel() <= _CHUNK:
        return fn(x)
    flat = x.reshape(-1)
    return torch.cat([fn(c) for c in flat.split(_CHUNK)]).view(x.shape)


def _sincosf(y: torch.Tensor, cosine: bool) -> torch.Tensor:
    if y.dtype != torch.float32:
        raise ValueError(f"sinf/cosf take float32, got {y.dtype}")
    return _chunked(lambda c: _sincosf_chunk(c, cosine), y)


def _sincosf_chunk(y: torch.Tensor, cosine: bool) -> torch.Tensor:
    xi = y.view(torch.int32).to(torch.int64) & _MASK
    top = (xi >> 20) & 0x7FF
    x = y.double()
    r, n, k = _reduce(x, xi, top)
    sign = torch.tensor([1.0, -1.0, -1.0, 1.0], dtype=torch.float64,
                        device=y.device)[k & 3]
    small = top < _TOP_SMALL
    q = torch.where(small, torch.zeros_like(n), n) ^ (1 if cosine else 0)
    xr = torch.where(small, x, r * sign)
    x2 = torch.where(small, x * x, r * r)
    out = _poly(xr, x2, (q & 1) == 1, ~small & ((k & 2) == 2)).float()
    tiny = top < _TOP_TINY
    out = torch.where(tiny, torch.ones_like(y) if cosine else y, out)
    return torch.where(top < _TOP_INF, out, torch.full_like(y, float("nan")))


def sinf(y: torch.Tensor) -> torch.Tensor:
    """glibc's float32 sinf, element by element, on y's device."""
    return _sincosf(y, cosine=False)


def cosf(y: torch.Tensor) -> torch.Tensor:
    """glibc's float32 cosf, element by element, on y's device."""
    return _sincosf(y, cosine=True)


def sqrt(v: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root, as XLA's: torch's float32 one on
    the CPU can miss by an ulp, so float32 goes through float64 (rounded
    once)."""
    if v.dtype == torch.float32:
        return torch.sqrt(v.double()).float()
    return torch.sqrt(v)


def sin(x: torch.Tensor) -> torch.Tensor:
    """The sine XLA's CPU code computes: glibc's in float32, torch's in
    float64."""
    return sinf(x) if x.dtype == torch.float32 else torch.sin(x)


def cos(x: torch.Tensor) -> torch.Tensor:
    """The cosine XLA's CPU code computes: glibc's in float32, torch's in
    float64."""
    return cosf(x) if x.dtype == torch.float32 else torch.cos(x)


# fdlibm's atanf (glibc sysdeps/ieee754/flt-32/s_atanf.c): float32
# arithmetic throughout, so torch's correctly rounded float32 operations
# give its bits.  atan(0.5), atan(1), atan(1.5), atan(inf) in two parts,
# and the odd polynomial's eleven coefficients.
_ATAN_HI = (4.6364760399e-01, 7.8539812565e-01, 9.8279368877e-01,
            1.5707962513e+00)
_ATAN_LO = (5.0121582440e-09, 3.7748947079e-08, 3.4473217170e-08,
            7.5497894159e-08)
_AT = (3.3333334327e-01, -2.0000000298e-01, 1.4285714924e-01,
       -1.1111110449e-01, 9.0908870101e-02, -7.6918758452e-02,
       6.6610731184e-02, -5.8335702866e-02, 4.9768779427e-02,
       -3.6531571299e-02, 1.6285819933e-02)


def atanf(x: torch.Tensor) -> torch.Tensor:
    """glibc's float32 atanf (which XLA's CPU code calls for a float32
    jnp.arctan, through atan2f(x, 1)), element by element."""
    if x.dtype != torch.float32:
        raise ValueError(f"atanf takes float32, got {x.dtype}")
    return _chunked(_atanf_chunk, x)


def _atanf_chunk(x: torch.Tensor) -> torch.Tensor:
    ix = x.view(torch.int32) & 0x7FFFFFFF
    a = torch.abs(x)
    one = torch.ones_like(a)
    ids = torch.full(x.shape, -1, dtype=torch.int64, device=x.device)
    # the reduction of |x| in [7/16, 2^25) to t in [-7/16, 7/16] around
    # atan(0.5), atan(1), atan(1.5) or atan(inf)
    t = x
    for lo, hi, k, fn in (
            (0x3ee00000, 0x3f300000, 0, lambda v: (2.0 * v - one) / (2.0 + v)),
            (0x3f300000, 0x3f980000, 1, lambda v: (v - one) / (v + one)),
            (0x3f980000, 0x401c0000, 2, lambda v: (v - 1.5) / (one + 1.5 * v)),
            (0x401c0000, 0x4c000000, 3, lambda v: -1.0 / v)):
        m = (ix >= lo) & (ix < hi)
        t = torch.where(m, fn(a), t)
        ids = torch.where(m, k, ids)
    z = t * t
    w = z * z
    s1 = _AT[10] * w
    for c in (_AT[8], _AT[6], _AT[4], _AT[2]):
        s1 = (s1 + c) * w
    s1 = z * (s1 + _AT[0])
    s2 = _AT[9] * w
    for c in (_AT[7], _AT[5], _AT[3]):
        s2 = (s2 + c) * w
    s2 = w * (s2 + _AT[1])
    small = t - t * (s1 + s2)
    kk = ids.clamp_min(0)
    hi_t = torch.tensor(_ATAN_HI, dtype=torch.float32, device=x.device)[kk]
    lo_t = torch.tensor(_ATAN_LO, dtype=torch.float32, device=x.device)[kk]
    big = hi_t - ((t * (s1 + s2) - lo_t) - t)
    big = torch.where(x < 0, -big, big)
    out = torch.where(ids < 0, small, big)
    out = torch.where(ix < 0x31000000, x, out)          # |x| < 2^-29: x
    # |x| >= 2^25: +-(atan(inf)'s two parts summed in float32); nan: x + x
    huge = torch.full_like(x, _ATAN_HI[3]) + _ATAN_LO[3]
    out = torch.where(ix >= 0x4c000000, torch.where(x < 0, -huge, huge), out)
    return torch.where(ix > 0x7f800000, x + x, out)


def atan(x: torch.Tensor) -> torch.Tensor:
    """The arctangent XLA's CPU code computes: glibc's in float32, torch's
    in float64."""
    return atanf(x) if x.dtype == torch.float32 else torch.atan(x)

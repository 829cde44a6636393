"""The threefry2x32 key stream of jax.random, bit for bit, in PyTorch.

The JAX package draws Minimax Protection's subsample from
`jax.random.permutation` of keys split out of `PRNGKey(seed + 1)`.  This
module reproduces the default generator of jax 0.9.0 (`threefry2x32` with
`jax_threefry_partitionable=True`) so that the port, given the same seed,
transmits the same instances:

    PRNGKey(seed)          (2,) key: the high and low 32-bit words of seed
    split(key, num)        (num, 2) keys: threefry of (0, k) for k < num
    fold_in(key, data)     the key threefry of (0, data): split's k-th key
    bits(key, shape)       uint32 words: the xor of threefry's two outputs
                           on the 64-bit counters 0 .. prod(shape) - 1;
                           width=64: the two outputs as high and low words
    uniform(key, shape, dtype, minval, maxval)
                           the mantissa bits under the exponent of 1.0,
                           minus 1, scaled and shifted (float32 from 32-bit
                           words, float64 from 64-bit ones, as jax under
                           jax_enable_x64)
    normal(key, shape, dtype)
                           sqrt(2) erf_inv(uniform on (-1, 1))
    permutation(key, n)    jax's sort-based shuffle of arange(n): per round
                           split the key, draw 32-bit sort keys, stable sort

`erf_inv` and the log1p under it are XLA's CPU code step for step: Cephes'
log1p and, in float32, Cephes' logf (XLA's own log), Giles' polynomials
selected per coefficient, square roots rounded once, and a fused
multiply-add wherever XLA's CPU backend fuses one (emulated exactly from
plain IEEE operations on the CPU, torch.addcmul on the card).  So the
integer work, the uniforms and the float32 normals match jax bit for bit
on either device (4 x 1e6 normals checked on the CPU).  Float64's log1p
ends in the C library's log under XLA and in torch.log here, which differ
in the last bit: float64 normals are within 3 ulp of jax's (99.996% equal
over 4 x 1e6 draws).

A key is an int64 tensor whose last axis holds the two uint32 words, so a
(B, 2) tensor is one key per Monte-Carlo trial and every function maps over
the leading axes.  Words are carried in int64 and masked to 32 bits after
each addition: torch's uint32 lacks shifts and rotations on some CUDA
builds.  Everything runs on the device of the key, with no host round trip.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

__all__ = ["PRNGKey", "split", "fold_in", "bits", "uniform", "normal",
           "erf_inv", "permutation", "threefry2x32", "shuffle_rounds"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def PRNGKey(seed: Union[int, Sequence[int], torch.Tensor],
            device="cpu") -> torch.Tensor:
    """The raw key of an integer seed, (2,); a sequence (or int tensor) of B
    seeds gives B keys, (B, 2).  A negative seed raises: jax keys it by the
    width of its integer (x32 and x64 give different keys)."""
    if not isinstance(seed, torch.Tensor) and np.any(np.asarray(seed) < 0):
        raise ValueError(f"PRNGKey: seeds must be >= 0, got {seed}")
    s = torch.as_tensor(seed, dtype=torch.int64).to(device)
    return torch.stack([(s >> 32) & _MASK, s & _MASK], dim=-1)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of the counter words (x0, x1)
    under the key words (k0, k1); all int64 holding uint32 values, any
    broadcastable shapes.  Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for block in range(5):
        for r in _ROTATIONS[block % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & _MASK
        x1 = (x1 + ks[(block + 2) % 3] + (block + 1)) & _MASK
    return x0, x1


def _counters(shape, device):
    """The two 32-bit words of the 64-bit iota over `shape` (jax's
    iota_2x32_shape)."""
    n = math.prod(shape)
    iota = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return iota >> 32, iota & _MASK


def _hash(key: torch.Tensor, shape):
    """threefry of the counters over `shape` under each key of `key`
    (..., 2): two words of shape (..., *shape)."""
    lead = key.shape[:-1]
    pad = (1,) * len(shape)
    k0 = key[..., 0].reshape(*lead, *pad)
    k1 = key[..., 1].reshape(*lead, *pad)
    hi, lo = _counters(shape, key.device)
    return threefry2x32(k0, k1, hi, lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`num` new keys from each key: (..., 2) -> (..., num, 2)."""
    w0, w1 = _hash(key, (num,))
    return torch.stack([w0, w1], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """A new key from `key` and a 32-bit integer: (..., 2) -> (..., 2),
    jax.random.fold_in's (threefry of the counter words (0, data))."""
    if not 0 <= data <= _MASK:
        raise ValueError(f"fold_in: data must be a uint32, got {data}")
    zero = torch.zeros((), dtype=torch.int64, device=key.device)
    w0, w1 = threefry2x32(key[..., 0], key[..., 1], zero, zero + data)
    return torch.stack([w0, w1], dim=-1)


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def bits(key: torch.Tensor, shape=(), width: int = 32) -> torch.Tensor:
    """Uniform random words of `shape` under each key: (..., 2) ->
    (..., *shape), int64.  width=32: uint32 values; width=64: the uint64
    words of jax.random.bits(key, shape, jnp.uint64) as int64 bit patterns
    (view them as uint64 in numpy)."""
    w0, w1 = _hash(key, _shape(shape))
    if width == 32:
        return w0 ^ w1
    if width != 64:
        raise ValueError(f"bits: width must be 32 or 64, got {width}")
    hi = w0 - ((w0 >> 31) << 32)        # the high word as a signed int32
    return (hi * (1 << 32)) | w1


def _mantissa(key: torch.Tensor, shape, dtype: torch.dtype) -> torch.Tensor:
    """The exponent of 1.0 over random mantissa bits, as `dtype`: uniform
    on [1, 2).  float64 takes the top 52 of the 64-bit word (hi, lo) as
    (hi << 20) | (lo >> 12), which needs no 64-bit logical shift."""
    w0, w1 = _hash(key, shape)
    if dtype == torch.float32:
        word = ((w0 ^ w1) >> 9) | 0x3F800000
        return word.to(torch.int32).view(torch.float32)
    if dtype == torch.float64:
        word = (w0 << 20) | (w1 >> 12) | 0x3FF0000000000000
        return word.view(torch.float64)
    raise ValueError(f"uniform: dtype must be float32 or float64, got {dtype}")


def _two_sum(a, b):
    """s = fl(a + b) and its exact error e: s + e = a + b (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _round_to_odd(s: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """The exact value s + e rounded to odd in s's format: s where it is
    exact or odd, else its neighbour towards e (which is odd)."""
    word = s.view(torch.int32 if s.dtype == torch.float32 else torch.int64)
    inexact_even = (e != 0) & ((word & 1) == 0)
    towards = torch.where(e > 0, math.inf, -math.inf).to(s.dtype)
    return torch.where(inexact_even, torch.nextafter(s, towards), s)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """a * b + c rounded once (b and c tensors or floats, rounded to a's
    dtype), as the fused multiply-adds XLA's CPU code compiles to.  On the
    card torch.addcmul is one: its CUDA code c + 1 * a * b contracts to an
    fma.  On the CPU (where addcmul rounds twice) it is built from plain
    IEEE operations.  float32: the product is exact in float64, and the
    float64 sum rounds to float32 correctly unless it is a float32 midpoint
    the exact sum is not; those few are rounded to odd first.  float64:
    Dekker's exact product, and Boldo and Melquiond's emulated FMA (round
    the low parts' sum to odd)."""
    if a.is_cuda:
        b, c = (v if isinstance(v, torch.Tensor) else torch.full_like(a, v)
                for v in (b, c))
        return torch.addcmul(c, a, b)
    if a.dtype == torch.float32:
        b, c = (v.double() if isinstance(v, torch.Tensor) else float(np.float32(v))
                for v in (b, c))
        p = a.double() * b
        s = p + c
        out = s.float()
        # a float32 midpoint: the low 29 bits are a one and 28 zeros
        tie = (s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000
        if bool(tie.any()):
            i = tie.nonzero(as_tuple=True)
            s_i, e_i = _two_sum(p[i], c[i] if isinstance(c, torch.Tensor) else c)
            out[i] = _round_to_odd(s_i, e_i).float()
        return out
    split = 134217729.0                 # 2**27 + 1: Veltkamp's split
    t = split * b
    bh = t - (t - b)
    bl = b - bh
    t = a * split
    ah = t - (t - a)
    al = a - ah
    uh = a * b
    ul = (((ah * bh - uh) + ah * bl) + al * bh) + al * bl
    th, tl = _two_sum(c if isinstance(c, torch.Tensor) else torch.full_like(uh, c), uh)
    v, e = _two_sum(tl, ul)
    return th + _round_to_odd(v, e)


def uniform(key: torch.Tensor, shape=(), dtype: torch.dtype = torch.float32,
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """Uniform on [minval, maxval) under each key: (..., 2) -> (..., *shape),
    jax.random.uniform bit for bit.  minval, maxval and their difference
    are formed in `dtype` first, then u * scale + minval with one rounding
    (jax's CPU code is a fused multiply-add); a power-of-two scale makes
    the product exact, and then the plain multiply and add."""
    np_dt = _NP[dtype]
    lo = np_dt(minval)
    scale = float(np_dt(maxval) - lo)
    u = _mantissa(key, _shape(shape), dtype) - 1.0
    if math.frexp(scale)[0] == 0.5:
        out = u * scale + float(lo)
    else:
        out = _fma(u, scale, float(lo))
    return torch.clamp_min(out, float(lo))


def normal(key: torch.Tensor, shape=(), dtype: torch.dtype = torch.float32
           ) -> torch.Tensor:
    """Standard normals under each key: (..., 2) -> (..., *shape), jax's
    sqrt(2) erf_inv(u) with u uniform on (-1, 1), within the ulp bounds of
    the module docstring."""
    np_dt = _NP[dtype]
    u = uniform(key, shape, dtype, float(np.nextafter(np_dt(-1.0), np_dt(0.0))))
    return erf_inv(u) * math.sqrt(2.0)


_NP = {torch.float32: np.float32, torch.float64: np.float64}

# XLA's ErfInv (M. Giles, "Approximating the erfinv function", 2010),
# coefficients highest first.  float32: w < 5 and w >= 5.
_ERFINV32 = (
    (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
     0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941),
    (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
     0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))
# float64: w < 6.25 (23 terms), w < 16 (19) and w >= 16 (17)
_ERFINV64 = (
    (-3.6444120640178196996e-21, -1.685059138182016589e-19,
     1.2858480715256400167e-18, 1.115787767802518096e-17,
     -1.333171662854620906e-16, 2.0972767875968561637e-17,
     6.6376381343583238325e-15, -4.0545662729752068639e-14,
     -8.1519341976054721522e-14, 2.6335093153082322977e-12,
     -1.2975133253453532498e-11, -5.4154120542946279317e-11,
     1.051212273321532285e-09, -4.1126339803469836976e-09,
     -2.9070369957882005086e-08, 4.2347877827932403518e-07,
     -1.3654692000834678645e-06, -1.3882523362786468719e-05,
     0.0001867342080340571352, -0.00074070253416626697512,
     -0.0060336708714301490533, 0.24015818242558961693,
     1.6536545626831027356),
    (2.2137376921775787049e-09, 9.0756561938885390979e-08,
     -2.7517406297064545428e-07, 1.8239629214389227755e-08,
     1.5027403968909827627e-06, -4.013867526981545969e-06,
     2.9234449089955446044e-06, 1.2475304481671778723e-05,
     -4.7318229009055733981e-05, 6.8284851459573175448e-05,
     2.4031110387097893999e-05, -0.0003550375203628474796,
     0.00095328937973738049703, -0.0016882755560235047313,
     0.0024914420961078508066, -0.0037512085075692412107,
     0.005370914553590063617, 1.0052589676941592334,
     3.0838856104922207635),
    (-2.7109920616438573243e-11, -2.5556418169965252055e-10,
     1.5076572693500548083e-09, -3.7894654401267369937e-09,
     7.6157012080783393804e-09, -1.4960026627149240478e-08,
     2.9147953450901080826e-08, -6.7711997758452339498e-08,
     2.2900482228026654717e-07, -9.9298272942317002539e-07,
     4.5260625972231537039e-06, -1.9681778105531670567e-05,
     7.5995277030017761139e-05, -0.00021503011930044477347,
     -0.00013871931833623122026, 1.0103004648645343977,
     4.8499064014085844221))


def _horner(coeffs, w: torch.Tensor) -> torch.Tensor:
    """c[0] w^(k-1) + ... + c[k-1] by Horner, each step p * w + c one fused
    multiply-add (XLA's CPU backend fuses them).  A coefficient is a float
    (rounded to w's dtype) or a tensor of one per element."""
    it = iter(coeffs)
    p = next(it)
    p = p if isinstance(p, torch.Tensor) else torch.full_like(w, p)
    for c in it:
        p = _fma(p, w, c)
    return p


def _per_element(tables, masks, like: torch.Tensor):
    """XLA's select-per-coefficient form of a piecewise polynomial: column
    by column, each element's coefficient from tables[i] at the first
    masks[i] it meets, else from tables[-1]; shorter tables are padded with
    leading zeros (a zero step is exact)."""
    k = max(map(len, tables))
    padded = [(0.0,) * (k - len(t)) + tuple(t) for t in tables]
    for column in zip(*padded):
        c = torch.full_like(like, column[-1])
        for v, m in zip(column[-2::-1], masks[::-1]):
            c = c.masked_fill(m, v)
        yield c


# XLA's log1p on the CPU (Cephes' form): a rational function of a where
# |a| < sqrt(2) - 1, log(1 + a) elsewhere.  Numerator and denominator,
# highest coefficient first (float32 rounds each to its nearest float).
_LOG1P_NUM = (4.52700008624452e-05, 0.49854102823193375, 6.578732594206104,
              29.911919328553072, 60.94966798098779, 57.11296359058554,
              20.039553499201283)
_LOG1P_DEN = (1.0, 15.062909083469192, 83.04756596796722, 221.76239823732857,
              309.09872225312057, 216.42788614495947, 60.11866049760384)
# XLA's float32 log (Cephes' logf as Eigen evaluates it): three quadratics
# in the reduced mantissa, joined over its cube; ln 2 in two parts.
_LOGF_P = ((7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1),
           (-1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1),
           (2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1))
_LOGF_Q1, _LOGF_Q2 = -2.12194440e-4, 0.693359375
_FLT_MIN = 2.0 ** -126


def _log32(t: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log for finite t >= 0: t = m 2^e with m in
    [sqrt(1/2), sqrt(2)), then ln m by Cephes' polynomial; -inf at 0 and,
    as under XLA's flush to zero, at subnormal t; NaN below 0."""
    b = torch.clamp_min(t, _FLT_MIN).view(torch.int32)
    m = ((b & 0x7FFFFF) | 0x3F000000).view(torch.float32)   # [0.5, 1)
    e = ((b >> 23) - 127).to(torch.float32) + 1.0
    low = m < 0.70710677
    x = (m - 1.0) + torch.where(low, m, 0.0)
    e = e - low.to(torch.float32)
    x2 = x * x
    x3 = x2 * x
    y, y1, y2 = (_horner(c, x) for c in _LOGF_P)
    y = _fma(_fma(y, x3, y1), x3, y2)
    out = ((x - x2 * 0.5) + _fma(y, x3, e * _LOGF_Q1)) + e * _LOGF_Q2
    return torch.where(t >= _FLT_MIN, out, torch.where(t >= 0, -math.inf, math.nan))


def _log1p(a: torch.Tensor) -> torch.Tensor:
    """log(1 + a) in the operations of XLA's CPU code, so float32 gives its
    bits; float64's log(1 + a) branch is the C library's log there and
    torch.log here."""
    a2 = a * a
    small = a + (a2 * -0.5 + (a * a2) * (_horner(_LOG1P_NUM, a)
                                         / _horner(_LOG1P_DEN, a)))
    t = a + 1.0
    large = _log32(t) if a.dtype == torch.float32 else torch.log(t)
    return torch.where(torch.abs(a) < 0.41421356237309503, small, large)


_CPU_CHUNK = 1 << 20


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """The inverse error function in XLA's form, for float32 or float64 x
    on (-1, 1); +-inf at +-1: w = -log1p(-x^2), then one polynomial in a
    shifted w or sqrt(w) whose coefficients each element picks by its
    branch of w (the steps and roundings of XLA's CPU code).  On the CPU
    it runs over chunks of 2^20 elements, whose temporaries stay in cache
    (3x faster at 8M elements; elementwise, so the same bits)."""
    if not x.is_cuda and x.numel() > _CPU_CHUNK:
        parts = [_erf_inv(c) for c in x.reshape(-1).split(_CPU_CHUNK)]
        return torch.cat(parts).view(x.shape)
    return _erf_inv(x)


def _erf_inv(x: torch.Tensor) -> torch.Tensor:
    w = -_log1p(-x * x)
    if x.dtype == torch.float32:
        low = w < 5.0
        # sqrt rounded once, as XLA's: torch's float32 sqrt on the CPU can
        # miss by an ulp, and a float64 root rounds to float32 exactly
        z = torch.where(low, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
        p = _horner(_per_element(_ERFINV32, [low], w), z)
    elif x.dtype == torch.float64:
        low, mid = w < 6.25, w < 16.0
        z = torch.where(low, w - 3.125,
                        torch.sqrt(w) - torch.full_like(w, 5.0).masked_fill(mid, 3.25))
        p = _horner(_per_element(_ERFINV64, [low, mid], w), z)
    else:
        raise ValueError(f"erf_inv: dtype must be float32 or float64, got {x.dtype}")
    return torch.where(torch.abs(x) == 1.0, x * math.inf, p * x)


def shuffle_rounds(n: int) -> int:
    """Sort rounds of jax's shuffle for n elements: ceil(3 ln n / ln(2^32 - 1)),
    evaluated as jax evaluates it (numpy float64)."""
    return int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """A random permutation of arange(n) (int64) per key: (..., 2) ->
    (..., n), jax.random.permutation(key, n)'s values."""
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    x = x.expand(*key.shape[:-1], n)
    for _ in range(shuffle_rounds(n)):
        keys = split(key)
        key, sub = keys[..., 0, :], keys[..., 1, :]
        order = torch.sort(bits(sub, (n,)), dim=-1, stable=True).indices
        x = torch.gather(x, -1, order)
    return x

"""Codec registry: what a residual payload looks like on the wire.

Twin of repro.transport.codecs.  A codec is an `encode` / `decode` pair
applied to every transmitted residual payload (rows along the last axis)
plus a byte model `nbytes(n_elems)` the ledger charges per payload;
`roundtrip` (decode after encode) is what the solvers call, since the shared
covariance state holds the decoded rows.

  exact_f64 / exact_f32 / exact_bf16   cast to the wire dtype and back;
                                       the identity (skipped by the relays)
                                       when the wire dtype holds the data's
  int8_affine    per row q = round((x - lo) / scale) in 256 levels, one
                 byte a value plus a float32 (scale, zero point) pair a row;
                 constant rows pass through exactly
  topk_sparse    the k largest |x| of a row as (float32 value, int32 index)
                 pairs, the rest decoding to zero; k clamped to the row

The lossy codecs do the operations of the JAX package's compiled sweep in
its order, so a round trip gives its bits: int8_affine takes the scale as a
product with the rounded reciprocal of 255 (XLA's rewrite of a division by
a constant) and decodes lo + q * scale as one fused multiply-add (XLA's
contraction; exact on the CPU through prng's emulation, `torch.addcmul` on
the card); topk_sparse keeps the lower index among equal |x|, as
`lax.top_k` does, by a stable descending sort (`torch.topk` makes no
promise on ties).
"""
from __future__ import annotations

import dataclasses
import functools
import inspect
from typing import Callable, Dict, Tuple

import torch

from repro_torch import prng
from repro_torch.transport.topology import TransportError

__all__ = ["Codec", "CODECS", "register_codec", "build_codec", "ExactCodec",
           "Int8AffineCodec", "TopKSparseCodec"]

_INDEX_BYTES = 4     # int32 wire index (topk_sparse)
_SCALE_BYTES = 8     # f32 scale + f32 zero-point per row (int8_affine)
_WIRE_DTYPES = {"float64": torch.float64, "float32": torch.float32,
                "bfloat16": torch.bfloat16}


@functools.lru_cache(maxsize=None)
def _reciprocal_255(dtype: torch.dtype) -> float:
    """1/255 rounded in `dtype`, as a Python number (a scalar operand: no
    host-to-device copy per round trip); exact in that dtype, so the
    product rounds once, as XLA's rewrite of (hi - lo) / 255 does."""
    return float(torch.ones((), dtype=dtype, device="cpu") / 255.0)


@dataclasses.dataclass(frozen=True)
class Codec:
    """Base codec: the identity wire format.  Subclasses override encode,
    decode, nbytes and is_identity_for."""

    name: str

    def encode(self, x: torch.Tensor):
        """x (..., m) -> the payload (what crosses one link)."""
        return x

    def decode(self, payload) -> torch.Tensor:
        """The payload -> (..., m) values."""
        return payload

    def nbytes(self, n_elems: int) -> float:
        """Wire bytes of one encoded payload of `n_elems` values."""
        raise NotImplementedError

    def is_identity_for(self, dtype: torch.dtype) -> bool:
        """True when the round trip is bit-exact for values of `dtype`."""
        return False

    def roundtrip(self, x: torch.Tensor) -> torch.Tensor:
        """decode(encode(x)) in x's dtype — the receiver's view after one
        hop."""
        return self.decode(self.encode(x)).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class ExactCodec(Codec):
    """Cast to a wire dtype and back: lossless when the wire dtype holds
    every value of the data's (exact_f32 and exact_bf16 round wider
    payloads)."""

    wire_dtype: str = "float64"
    itemsize: int = 8

    def encode(self, x):
        if self.is_identity_for(x.dtype):
            return x
        return x.to(_WIRE_DTYPES[self.wire_dtype])

    def nbytes(self, n_elems: int) -> float:
        return float(n_elems * self.itemsize)

    def is_identity_for(self, dtype) -> bool:
        wire = _WIRE_DTYPES[self.wire_dtype]
        return torch.promote_types(dtype, wire) == wire


@dataclasses.dataclass(frozen=True)
class Int8AffineCodec(Codec):
    """Per-row affine quantisation to 256 levels: q = round((x - lo) /
    scale), one uint8 a value plus the row's (scale, zero point).  Constant
    rows (scale 0) pass through exactly."""

    def encode(self, x):
        lo = torch.amin(x, dim=-1, keepdim=True)
        hi = torch.amax(x, dim=-1, keepdim=True)
        scale = (hi - lo) * _reciprocal_255(x.dtype)
        safe = torch.where(scale > 0, scale, torch.ones_like(scale))
        q = torch.clamp(torch.round((x - lo) / safe), 0, 255).to(torch.uint8)
        return {"q": q, "lo": lo, "scale": scale}

    def decode(self, payload):
        lo, scale = payload["lo"], payload["scale"]
        q = payload["q"].to(lo.dtype)
        return prng._fma(q, scale.expand_as(q), lo.expand_as(q))

    def nbytes(self, n_elems: int) -> float:
        return float(n_elems * 1 + _SCALE_BYTES)


@dataclasses.dataclass(frozen=True)
class TopKSparseCodec(Codec):
    """Keep the k largest-|x| entries per row (f32 value + int32 index
    each); the rest decode to zero.  k is clamped to the row length."""

    k: int = 64

    def _k(self, m: int) -> int:
        return max(1, min(self.k, m))

    def encode(self, x):
        k = self._k(x.shape[-1])
        order = torch.sort(torch.abs(x), dim=-1, descending=True,
                           stable=True).indices[..., :k]
        kept = torch.gather(x, -1, order).to(torch.float32)
        return {"values": kept, "indices": order.to(torch.int32),
                "length": x.shape[-1]}

    def decode(self, payload):
        vals = payload["values"]
        out = torch.zeros((*vals.shape[:-1], payload["length"]),
                          dtype=vals.dtype, device=vals.device)
        return out.scatter(-1, payload["indices"].to(torch.int64), vals)

    def nbytes(self, n_elems: int) -> float:
        return float(self._k(n_elems) * (4 + _INDEX_BYTES))


@dataclasses.dataclass(frozen=True)
class _CodecFactory:
    name: str
    fn: Callable[..., Codec]
    options: Tuple[str, ...]


CODECS: Dict[str, _CodecFactory] = {}


def register_codec(name: str):
    """Register a `(**options) -> Codec` factory."""

    def deco(fn):
        params = list(inspect.signature(fn).parameters)
        CODECS[name] = _CodecFactory(name=name, fn=fn, options=tuple(params))
        return fn

    return deco


def build_codec(name: str, options=()) -> Codec:
    factory = CODECS.get(name)
    if factory is None:
        raise TransportError(f"unknown codec {name!r}; "
                             f"registered: {sorted(CODECS)}")
    kw = dict(options)
    unknown = sorted(set(kw) - set(factory.options))
    if unknown:
        raise TransportError(f"codec {name!r} has no option(s) {unknown}; "
                             f"valid: {sorted(factory.options)}")
    return factory.fn(**kw)


@register_codec("exact_f64")
def _exact_f64() -> Codec:
    return ExactCodec(name="exact_f64", wire_dtype="float64", itemsize=8)


@register_codec("exact_f32")
def _exact_f32() -> Codec:
    return ExactCodec(name="exact_f32", wire_dtype="float32", itemsize=4)


@register_codec("exact_bf16")
def _exact_bf16() -> Codec:
    return ExactCodec(name="exact_bf16", wire_dtype="bfloat16", itemsize=2)


@register_codec("int8_affine")
def _int8_affine() -> Codec:
    return Int8AffineCodec(name="int8_affine")


@register_codec("topk_sparse")
def _topk_sparse(k: int = 64) -> Codec:
    if k < 1:
        raise TransportError(f"topk_sparse needs k >= 1, got {k}")
    return TopKSparseCodec(name="topk_sparse", k=int(k))

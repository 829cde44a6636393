"""Codec registry: what a residual payload looks like on the wire.

Twin of repro.transport.codecs holding the exact codecs of this slice:
`exact_f64` and `exact_f32` cast to the wire dtype and back, with a byte
model of `itemsize` bytes a value whatever the data dtype.  A codec is the
identity (and the relays skip it) when the wire dtype holds every value of
the data dtype.  The lossy codecs (exact_bf16, int8_affine, topk_sparse)
wait for ROADMAP A9.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, Dict, Tuple

import torch

from repro_torch.transport.topology import TransportError

__all__ = ["Codec", "CODECS", "register_codec", "build_codec", "ExactCodec"]

_WIRE_DTYPES = {"float64": torch.float64, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class Codec:
    """Base codec: subclasses define the round trip and the byte model."""

    name: str

    def roundtrip(self, x: torch.Tensor) -> torch.Tensor:
        """decode(encode(x)) — the receiver's view after one hop."""
        raise NotImplementedError

    def nbytes(self, n_elems: int) -> float:
        """Wire bytes of one encoded payload of `n_elems` values."""
        raise NotImplementedError

    def is_identity_for(self, dtype: torch.dtype) -> bool:
        """True when the round trip is bit-exact for values of `dtype`."""
        return False


@dataclasses.dataclass(frozen=True)
class ExactCodec(Codec):
    """Cast to a wire dtype and back: lossless when the wire dtype is at
    least as wide as the data (exact_f32 rounds f64 payloads)."""

    wire_dtype: str = "float64"
    itemsize: int = 8

    def roundtrip(self, x):
        if self.is_identity_for(x.dtype):
            return x
        return x.to(_WIRE_DTYPES[self.wire_dtype]).to(x.dtype)

    def nbytes(self, n_elems: int) -> float:
        return float(n_elems * self.itemsize)

    def is_identity_for(self, dtype) -> bool:
        wire = _WIRE_DTYPES[self.wire_dtype]
        return torch.promote_types(dtype, wire) == wire


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

"""Deterministic chunked arrival stream over the data.sources registry (twin
of repro.stream.source).

`ChunkSource` turns any registered generator into a stream of `(x, y)`
micro-batches: chunk t is drawn from `fold_in(PRNGKey(seed), t)` through
the source's raw generator (no standardisation, no partition) on the
source's device — a pure function of (seed, t), which is what makes
elastic restarts bit-identical (stream.run resumes by regenerating exactly
the chunks it has not ingested yet).  The JAX package's chunks, bit for
bit, in float32 and float64, with and without drift.

Drift (`drift_option`) moves the named option linearly from `start` to
`end` over the stream's `total_chunks`.  The JAX package computes the
value as a float32 scalar, `start + (end - start) * (float32(t) *
frac_scale)`, inside its compiled chunk program, where XLA folds the two
constants into one (C = float32(frac_scale) * float32(end - start)) and
contracts the rest into one fused multiply-add, fma(float32(t), C, start).
It is computed here the same way, in float32 on the host, and reaches the
generator as a float32 0-d tensor on the device: under float64 data it
therefore differs from a Python-float option, as there.

Inside that compiled program XLA also contracts each `a + b * c` of a
generator into one fused multiply-add.  `COMPILED` holds the twins of the
friedman1 and cosine generators with those contractions (prng._fma: one
rounding on the CPU, torch.addcmul on the card), so their float32 chunks
equal the JAX package's bit for bit, drifting or not, with or without
noise; the other sources draw through their eager generators (ROADMAP
P4).  In float64 XLA's sine and cosine are its own (within an ulp of
torch's).
"""
from __future__ import annotations

import math
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.data import friedman, libm
from repro_torch.data.sources import SOURCES

__all__ = ["ChunkSource", "COMPILED"]


def _plus_noise(y: torch.Tensor, key, noise: float, dtype) -> torch.Tensor:
    """y + noise * normal(key) as XLA compiles it: the normal's sqrt(2) and
    the noise folded into one constant, then one fused multiply-add on
    erf_inv(u)."""
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    u = prng.uniform(key, y.shape[-1:], dtype,
                     float(np.nextafter(np_dt(-1.0), np_dt(0.0))))
    return prng._fma(prng.erf_inv(u), float(np_dt(math.sqrt(2.0)) * np_dt(noise)), y)


def _friedman1(key, n: int, n_attrs: int, noise: float, dtype):
    """friedman1 as XLA compiles it: 10 sin(pi x1 x2) + 20 (x3 - 1/2)^2 +
    10 x4 + 5 x5 + noise e, each sum after the first a fused multiply-add."""
    kx, kw = prng.split(key).unbind(-2)
    x = prng.uniform(kx, (n, 5), dtype)
    y = prng._fma(libm.sin(math.pi * x[..., 0] * x[..., 1]), 10.0,
                  20.0 * (x[..., 2] - 0.5) ** 2)
    y = prng._fma(x[..., 4], 5.0, prng._fma(x[..., 3], 10.0, y))
    return x, friedman._normalise(_plus_noise(y, kw, noise, dtype))


def _cosine(key, n: int, n_attrs: int, noise: float, dtype, freq=1.0):
    """cosine as XLA compiles it: the components' sum in XLA's order, the
    noise term a fused multiply-add."""
    kx, kw = prng.split(key).unbind(-2)
    x = prng.uniform(kx, (n, n_attrs), dtype)
    j = torch.arange(n_attrs, dtype=dtype, device=key.device)
    comps = libm.cos(2.0 * math.pi * freq * (j + 1.0) * x) / (j + 1.0)
    y = _plus_noise(friedman.xla_sum(comps, -1), kw, noise, dtype)
    return x, friedman._normalise(y)


# the generators as the JAX package's compiled chunk program computes them
COMPILED = {"friedman1": _friedman1, "cosine": _cosine}


class ChunkSource:
    """`(chunk_idx) -> (x, y)` stream of arrival micro-batches on `device`
    (the card unless the caller asks for the CPU), in `dtype` (torch's
    default float dtype when None)."""

    def __init__(self, source: str, chunk: int, total_chunks: int,
                 seed: int = 0, noise: float = 0.0,
                 n_attrs: Optional[int] = None,
                 options: Sequence[Tuple[str, Any]] = (),
                 drift_option: Optional[str] = None,
                 drift_start: float = 0.0, drift_end: float = 0.0,
                 device="cuda", dtype: Optional[torch.dtype] = None):
        from repro_torch.api.runner import resolve_device   # api imports us

        src = SOURCES.get(source)
        if src is None:
            raise ValueError(f"unknown data source {source!r}; "
                             f"registered: {sorted(SOURCES)}")
        if drift_option is not None and drift_option not in src.options:
            raise ValueError(f"source {source!r} has no option "
                             f"{drift_option!r} to drift; valid: "
                             f"{sorted(src.options)}")
        self._fn = COMPILED.get(source, src.fn)
        self.n_attrs = src.resolve_n_attrs(n_attrs)
        self.chunk = chunk
        self.total_chunks = total_chunks
        self.noise = noise
        self.device = resolve_device(device, "repro_torch.stream.ChunkSource")
        self.dtype = torch.get_default_dtype() if dtype is None else dtype
        self._base_key = prng.PRNGKey(seed, device=self.device)
        self._options = dict(options)
        self.drift_option = drift_option
        # float32, as the JAX package's traced scalar: the slope folded
        # from the fraction's scale and the span, as XLA folds it
        frac_scale = np.float32(1.0 / max(total_chunks - 1, 1))
        self._slope = float(frac_scale * np.float32(drift_end - drift_start))
        self._start = float(np.float32(drift_start))

    def drift_value(self, t: int) -> torch.Tensor:
        """The drifting option's float32 value at chunk t (a 0-d CPU
        tensor): fma(float32(t), slope, start), rounded once."""
        return prng._fma(torch.tensor([float(t)], dtype=torch.float32, device="cpu"),
                         self._slope, self._start)[0]

    def __call__(self, t: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Chunk t: x (chunk, n_attrs), y (chunk,) — pure in (seed, t)."""
        kw = dict(self._options)
        if self.drift_option is not None:
            kw[self.drift_option] = self.drift_value(t).to(self.device)
        key = prng.fold_in(self._base_key, t)
        return self._fn(key, self.chunk, self.n_attrs, self.noise, self.dtype,
                        **kw)

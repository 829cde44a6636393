"""Live ensemble predict engine: bucketed batch sizes, static shapes
(twin of repro.stream.serve).

A request batch is padded up to the smallest bucket that fits (oversized
requests stride through the largest bucket), so the engine runs one
program shape per bucket, each warmed up front by `warmup()`.  `update()`
swaps in fresh (params, weights) references — a plain attribute write —
which is what lets the stream loop publish new weights while request
threads keep calling `predict()`: the engine never mutates a published
tensor in place.
"""
from __future__ import annotations

import time
from typing import Any, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import ensemble
from repro_torch.obs import health as obs_health

__all__ = ["PredictEngine"]


def _wait(t: torch.Tensor) -> None:
    """Block until `t` is computed (the card's counterpart of jax's
    block_until_ready; a CPU tensor is ready when returned)."""
    if t.is_cuda:
        ev = torch.cuda.Event()
        ev.record()
        ev.synchronize()


class PredictEngine:
    """Batched low-latency ensemble predict against live combination weights.

    `groups` is the attribute partition; requests arrive as full-attribute
    rows `x : (B, n_attrs)` and are sliced into per-agent column views."""

    def __init__(self, family, groups: Sequence[Sequence[int]], n_attrs: int,
                 buckets: Sequence[int] = (1, 16, 128)):
        if not buckets or any(b < 1 for b in buckets):
            raise ValueError("need at least one positive bucket size")
        self.family = family
        self.n_attrs = n_attrs
        self.buckets: Tuple[int, ...] = tuple(sorted(set(int(b) for b in buckets)))
        self._groups = [list(g) for g in groups]
        self._gidx: Optional[torch.Tensor] = None
        # (params, weights) as last published: one reference, swapped
        # whole, so a request never pairs one publish's params with
        # another's weights
        self._live: Optional[Tuple[Any, torch.Tensor]] = None
        # one latency ring per bucket, fed by the engine itself: pad +
        # execute + wait on the output, the request-visible cost
        self.latency = {b: obs_health.LatencyRing() for b in self.buckets}
        self.requests = obs_health.Counter()

    def _predict(self, params, weights, x: torch.Tensor) -> torch.Tensor:
        xc = x[:, self._gidx].permute(1, 0, 2)             # (D, b, C)
        return ensemble.combine(weights, self.family.predict(params, xc))

    def update(self, params: Any, weights: torch.Tensor,
               alive: Optional[torch.Tensor] = None) -> None:
        """Publish fresh model state — an attribute swap.

        `alive` ((D,) bool, fault-degraded serving) masks dead agents out
        of the served combination and renormalises the survivors' weights,
        so a crash between publishes can never serve a dead agent's stale
        predictions.  Zero survivors degrade to uniform over all agents."""
        if alive is not None:
            w = torch.where(alive, weights, torch.zeros_like(weights))
            s = torch.sum(w)
            ok = s > 0
            weights = torch.where(
                ok, w / torch.where(ok, s, torch.ones_like(s)),
                torch.full_like(weights, 1.0 / weights.shape[0]))
        if self._gidx is None or self._gidx.device != weights.device:
            self._gidx = torch.tensor(self._groups, dtype=torch.int64,
                                      device=weights.device)
        self._live = (params, weights)

    def warmup(self) -> None:
        """Run every bucket once up front (requires update() first)."""
        if self._live is None:
            raise ValueError("PredictEngine.warmup before update(): no live "
                             "params to run against")
        params, w = self._live
        for b in self.buckets:
            _wait(self._predict(params, w,
                                torch.zeros((b, self.n_attrs), dtype=w.dtype,
                                            device=w.device)))

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _predict_one(self, live, x: torch.Tensor, n: int) -> torch.Tensor:
        """One bucket execution against `live` (params, weights), timed end
        to end into its ring (pad + execute + wait on the output)."""
        b = self._bucket(n)
        params, weights = live
        t0 = time.perf_counter()
        if n < b:
            x = torch.cat([x, x.new_zeros((b - n, x.shape[1]))])
        out = self._predict(params, weights, x)
        _wait(out)
        self.latency[b].observe(time.perf_counter() - t0)
        return out[:n]

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        """(B, n_attrs) -> (B,) ensemble predictions at the live weights.
        B <= max bucket: one padded call; larger B strides through the
        largest bucket.  Blocks on the result, so the observed latency is
        the caller's."""
        live = self._live                                # one snapshot
        if live is None:
            raise ValueError("PredictEngine.predict before update(): no live "
                             "params/weights have been published")
        self.requests.add(1)
        x = torch.as_tensor(x, device=live[1].device)
        n = x.shape[0]
        big = self.buckets[-1]
        if n > big:
            return torch.cat([self._predict_one(live, x[i:i + big],
                                                min(big, n - i))
                              for i in range(0, n, big)])
        return self._predict_one(live, x, n)

    # ------------------------------------------------------- metrics hook

    def metrics_rows(self, ingestor=None) -> List[tuple]:
        """(name, type, help, value, labels) rows for
        obs.health.prometheus_text — the engine's request and latency state
        plus, with an `Ingestor`, its throughput counters and last
        prequential MSE (the JAX package's row names)."""
        rows: List[tuple] = [
            ("repro_serve_requests_total", "counter",
             "predict() calls answered", float(self.requests.total), None),
            ("repro_serve_requests_per_second", "gauge",
             "request rate over the observed span", self.requests.rate, None),
        ]
        for b in self.buckets:
            ring = self.latency[b]
            lab = {"bucket": str(b)}
            rows.append((
                "repro_serve_predict_executions_total", "counter",
                "bucket program executions", float(ring.count), lab))
            for q, v in ring.percentiles().items():
                rows.append((
                    "repro_serve_predict_latency_seconds", "gauge",
                    "end-to-end bucket execution latency (ring window)",
                    v, {**lab, "quantile": q}))
        if ingestor is not None:
            for name, c in ingestor.counters.items():
                rows.append((f"repro_stream_{name}_total", "counter",
                             f"stream {name.replace('_', ' ')}",
                             float(c.total), None))
                rows.append((f"repro_stream_{name}_per_second", "gauge",
                             f"stream {name.replace('_', ' ')} rate",
                             c.rate, None))
            rows.append(("repro_stream_preq_mse", "gauge",
                         "prequential MSE of the last resweep record",
                         ingestor.last_preq_mse, None))
        return rows

    def metrics_text(self, ingestor=None) -> str:
        """Prometheus text exposition (v0.0.4) of `metrics_rows`."""
        return obs_health.prometheus_text(self.metrics_rows(ingestor))

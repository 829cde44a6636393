"""Runtime health primitives for the online path (twin of repro.obs.health:
numpy only, so the port keeps its own copy; the same rows give the same
Prometheus text).

`LatencyRing` is a fixed-capacity ring of float64 samples designed for the
serve loop's single-writer / many-reader pattern: `observe()` is two numpy
scalar stores (no lock taken — the GIL serialises the stores, and a reader
that races a write sees at worst one stale sample, never a torn structure);
`percentiles()` snapshots the filled prefix and computes on the copy.
`Counter` is a monotone event counter with a first/last timestamp pair, so
throughput is derived from observed wall time instead of a caller's own
stopwatch arithmetic.

`prometheus_text` renders a metric list in the Prometheus text exposition
format (v0.0.4) — the `stream.serve.metrics_text` hook builds its payload
with it.
"""
from __future__ import annotations

import time
from typing import Dict, Iterable, Mapping, Optional, Sequence, Tuple

import numpy as np

__all__ = ["Counter", "LatencyRing", "prometheus_text"]


class Counter:
    """Monotone event counter with observed first/last wall timestamps."""

    def __init__(self) -> None:
        self.total = 0
        self.first_t: Optional[float] = None
        self.last_t: Optional[float] = None

    def add(self, n: int = 1) -> None:
        now = time.time()
        if self.first_t is None:
            self.first_t = now
        self.last_t = now
        self.total += n

    @property
    def rate(self) -> float:
        """Events/second over the observed span (0.0 before two samples)."""
        if self.first_t is None or self.last_t is None \
                or self.last_t <= self.first_t:
            return 0.0
        return self.total / (self.last_t - self.first_t)


class LatencyRing:
    """Lock-free fixed-capacity latency sample ring (seconds)."""

    def __init__(self, capacity: int = 2048) -> None:
        if capacity < 1:
            raise ValueError(f"need capacity >= 1, got {capacity}")
        self.capacity = capacity
        self._buf = np.zeros((capacity,), np.float64)
        self._n = 0          # total observations ever (monotone)

    def observe(self, seconds: float) -> None:
        # write the slot BEFORE publishing the count: a reader snapshotting
        # at the old count never sees the half-written sample
        self._buf[self._n % self.capacity] = seconds
        self._n += 1

    @property
    def count(self) -> int:
        return self._n

    def snapshot(self) -> np.ndarray:
        """Copy of the filled samples (unordered once the ring has wrapped)."""
        n = min(self._n, self.capacity)
        return self._buf[:n].copy()

    def percentiles(self, qs: Sequence[float] = (50, 95, 99)
                    ) -> Dict[str, float]:
        """{"p50": seconds, ...} over the ring's current window (NaN when
        empty, so an unexercised bucket is visibly absent, not zero)."""
        s = self.snapshot()
        if s.size == 0:
            return {f"p{g:g}": float("nan") for g in qs}
        vals = np.percentile(s, list(qs))
        return {f"p{g:g}": float(v) for g, v in zip(qs, vals)}


def prometheus_text(metrics: Iterable[Tuple[str, str, str, float,
                                            Optional[Mapping[str, str]]]]
                    ) -> str:
    """Render (name, type, help, value, labels) rows as Prometheus text.

    Rows sharing a name emit one HELP/TYPE header (first row's wins).  NaN
    values render as `NaN` — valid exposition for an empty histogram window.
    """
    lines = []
    seen = set()
    for name, mtype, help_, value, labels in metrics:
        if name not in seen:
            seen.add(name)
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {mtype}")
        label_s = ""
        if labels:
            inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
            label_s = "{" + inner + "}"
        lines.append(f"{name}{label_s} {value}")
    return "\n".join(lines) + "\n"

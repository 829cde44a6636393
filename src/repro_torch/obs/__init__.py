"""repro_torch.obs — telemetry of the port (twin of repro.obs).

Three layers, one subsystem:

  * **in-sweep taps** (spec.py / taps.py): a static `ObsSpec` on the
    experiment spec selects named per-sweep values — eta, the solve vector
    s, commit acceptance, budget rejections, fault retry counts, codec
    round-trip error — collected inside the sweep and surfaced as
    `Result.metrics` / `StreamResult.metrics`.  Off by default: the off
    mode adds no device operation.
  * **host-side span tracer** (trace.py): `obs.trace`/`obs.event` emit
    structured JSONL (rendered by tools/obs_report.py) plus
    torch.profiler ranges.
  * **runtime health** (health.py): lock-free latency rings and throughput
    counters for the stream/serve loop, exported as Prometheus text via
    `stream.serve.PredictEngine.metrics_text`.

Imports torch, numpy and core.trial_index's indexing; api, core.icoa and
stream import this package, never the reverse.
"""
from __future__ import annotations

from repro_torch.obs.health import Counter, LatencyRing, prometheus_text
from repro_torch.obs.spec import ALL_TAPS, TAPS, ObsError, ObsSpec
from repro_torch.obs.taps import Metrics
from repro_torch.obs.trace import (Tracer, active, configure, disable, event,
                                   step, trace)

__all__ = [
    "ALL_TAPS", "Counter", "LatencyRing", "Metrics", "ObsError", "ObsSpec",
    "TAPS", "Tracer", "active", "configure", "disable", "event",
    "prometheus_text", "step", "trace",
]

"""Host-side span tracer: structured JSONL event logs + profiler annotations
(twin of repro.obs.trace).

The tracer instruments the host orchestration layer (api.fit, stream_fit's
resweep cadence, checkpoint saves, fault-schedule boundaries); in-sweep
telemetry is the tap layer's job (obs.taps).  Disabled (the default) every
`trace()` / `event()` call writes nothing, so instrumented call sites cost
nothing in production paths.

    from repro_torch import obs

    obs.configure("events.jsonl", run_id="demo")
    with obs.trace("fit", solver="icoa"):
        ...
    obs.event("record", count=2048, bytes_total=163840)
    obs.disable()

Schema (one JSON object per line, the JAX package's, so
tools/obs_report.py renders either package's logs):

    {"ev": "span",  "name": ..., "run": ..., "t": <wall s>, "dur_s": ...,
     "tags": {...}}
    {"ev": "event", "name": ..., "run": ..., "t": <wall s>, "tags": {...}}

Spans also open a `torch.profiler.record_function` of their name (and
`step()` one named `name#step`), so the same names land in the
torch.profiler captures of a run.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Any, Dict, Iterator, Optional

import torch

__all__ = ["Tracer", "configure", "disable", "active", "trace", "event",
           "step"]


class Tracer:
    """Appends structured span/event lines to a JSONL file (thread-safe)."""

    def __init__(self, path: str, run_id: Optional[str] = None) -> None:
        self.path = path
        self.run_id = run_id
        self._fh = open(path, "a")
        self._lock = threading.Lock()

    def _emit(self, obj: Dict[str, Any]) -> None:
        if self.run_id is not None:
            obj["run"] = self.run_id
        line = json.dumps(obj, default=str)
        with self._lock:
            self._fh.write(line + "\n")
            self._fh.flush()

    def span(self, name: str, t_start: float, dur_s: float,
             tags: Dict[str, Any]) -> None:
        self._emit({"ev": "span", "name": name, "t": t_start,
                    "dur_s": dur_s, "tags": tags})

    def event(self, name: str, tags: Dict[str, Any]) -> None:
        self._emit({"ev": "event", "name": name, "t": time.time(),
                    "tags": tags})

    def close(self) -> None:
        with self._lock:
            self._fh.close()


_tracer: Optional[Tracer] = None


def configure(path: str, run_id: Optional[str] = None) -> Tracer:
    """Open `path` (append mode) as the process-wide JSONL sink."""
    global _tracer
    if _tracer is not None:
        _tracer.close()
    _tracer = Tracer(path, run_id=run_id)
    return _tracer


def disable() -> None:
    """Close the sink; trace()/event() write nothing again."""
    global _tracer
    if _tracer is not None:
        _tracer.close()
        _tracer = None


def active() -> bool:
    return _tracer is not None


@contextlib.contextmanager
def _span(label: str, name: str, tags: Dict[str, Any]) -> Iterator[None]:
    t_wall = time.time()
    t0 = time.perf_counter()
    with torch.profiler.record_function(label):
        try:
            yield
        finally:
            if _tracer is not None:
                _tracer.span(name, t_wall, time.perf_counter() - t0, tags)


def trace(name: str, **tags: Any):
    """Span context manager: a JSONL line (when `configure()` armed the
    tracer) and a torch.profiler.record_function, which costs nothing
    unless a profiler is recording."""
    return _span(name, name, tags)


def event(name: str, **tags: Any) -> None:
    """Point-in-time structured event (no-op when not configured)."""
    if _tracer is not None:
        _tracer.event(name, tags)


def step(name: str, step_num: int, **tags: Any):
    """A span that marks a step: its profiler range is named `name#step`
    and its JSONL line carries the step in its tags."""
    return _span(f"{name}#{step_num}", name, dict(tags, step=step_num))

"""stream_fit: the online run loop, spec in, StreamResult out (twin of
repro.stream.run).

The loop is plain host Python: draw chunk t (pure in (seed, t)), `ingest`
it, every `resweep_every` instances run the cadenced `resweep` and record,
every `checkpoint_every` instances save the live state.  All schedule
arithmetic is host integers.

Elasticity: pass `checkpoint_dir` (and set spec.checkpoint_every) to save;
pass `resume=True` to continue from the newest checkpoint — the arrival
stream replays from chunk count / chunk, and because chunks are pure in
(seed, t) the resumed history (ledger bytes included) is the
uninterrupted run's, bit for bit.  Either package's checkpoints resume.

Serving: pass a `stream.PredictEngine` as `engine` and the loop publishes
fresh (params, weights) to it after every ingest and resweep — request
threads call `engine.predict()` concurrently against whatever was last
published.

Spans and events (obs.trace, when a tracer is configured): a
`stream.fit` span, a `stream.resweep` span per resweep (tagged with its
fault round and count), a `stream.record` event per record, a
`fault.crash` event per agent newly down under a crash schedule, and a
`stream.checkpoint` span per save.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.analysis import sanitize
from repro_torch.core import icoa
from repro_torch.faults import trace as faults_trace
from repro_torch.obs import taps as obs_taps
from repro_torch.obs.trace import active as obs_active
from repro_torch.obs.trace import event as obs_event
from repro_torch.obs.trace import trace as obs_span
from repro_torch.stream.checkpoint import restore_stream, save_stream
from repro_torch.stream.ingest import Ingestor, StreamState
from repro_torch.stream.serve import PredictEngine
from repro_torch.stream.source import ChunkSource

if TYPE_CHECKING:              # api imports this module: no cycle at run time
    from repro_torch.api.specs import StreamSpec

__all__ = ["StreamResult", "stream_fit", "build_ingestor"]


@dataclasses.dataclass
class StreamResult:
    """One online run: the per-resweep history plus the final live state."""

    spec: StreamSpec
    family: Any
    params: Any                 # final stacked agent params
    weights: torch.Tensor       # final live combination weights
    records: List[Dict[str, Any]]   # one dict per resweep (see Ingestor)
    state: StreamState          # final live state (checkpointable)
    metrics: Optional[obs_taps.Metrics] = None  # obs taps, one row per
    #                             executed sweep across all resweeps (None
    #                             when spec.experiment.obs is off)
    ingestor: Optional[Ingestor] = None  # the Ingestor that drove the run
    #                             (its obs.health counters)

    @property
    def counts(self) -> List[int]:
        return [r["count"] for r in self.records]

    @property
    def train_mse(self) -> List[float]:
        """Windowed train MSE at each resweep record."""
        return [r["train_mse"] for r in self.records]

    @property
    def test_mse(self) -> List[float]:
        """Prequential (predict-then-ingest) MSE per cadence period."""
        return [r["preq_mse"] for r in self.records]

    @property
    def eta(self) -> List[float]:
        return [r["eta"] for r in self.records]

    @property
    def total_bytes(self) -> int:
        """Cumulative measured re-sweep wire bytes (transport ledger)."""
        return self.records[-1]["bytes_total"] if self.records else 0


def build_ingestor(spec: StreamSpec, device="cuda") -> Ingestor:
    """Resolve the spec's family, partition and transport into an Ingestor
    on `device` (the card unless the caller asks for the CPU)."""
    spec.validate()
    exp = spec.experiment
    groups = exp.data.groups
    cfg = exp.solver.icoa_config(exp.resolved_transport(),
                                 checks=exp.backend.checks,
                                 obs=exp.obs.normalized())
    # the run's worst case of sweeps: every sweep of every cadence period
    total_sweeps = max(1, (spec.total_instances // spec.resweep_every)
                       * spec.sweeps_per_resweep)
    cfg = dataclasses.replace(cfg, n_sweeps=total_sweeps)
    family = exp.agent.resolve(n_cols=len(groups[0]))
    return Ingestor(family, groups, cfg, spec.window, spec.chunk,
                    seed=exp.seed, sweeps_per_resweep=spec.sweeps_per_resweep,
                    device=device)


@icoa._full_fp32
def stream_fit(spec: StreamSpec, *, checkpoint_dir: Optional[str] = None,
               resume: bool = False, engine: Optional[PredictEngine] = None,
               device="cuda") -> StreamResult:
    """Drive `spec.total_instances` arrivals through the online ICOA loop on
    `device` (the card unless the caller asks for the CPU), float32
    products in full fp32 (TF32 off) as in api.fit.

    Returns a StreamResult whose records are the per-resweep history
    (windowed train MSE, prequential test MSE, eta, measured re-sweep
    bytes, taps).  `resume=True` restores the newest checkpoint in
    `checkpoint_dir` and continues the stream from there.  Under
    `BackendSpec(checks="raise")` the ingest's and the resweeps' check
    sites fold into the run's error word, read after every resweep and at
    the end: a failure raises analysis.CheckError naming its site."""
    from repro_torch.api.runner import resolve_device

    dev = resolve_device(device, "repro_torch.api.stream_fit")
    spec.validate()
    exp = spec.experiment
    ing = build_ingestor(spec, dev)
    total_chunks = spec.total_instances // spec.chunk
    source = ChunkSource(
        exp.data.source, spec.chunk, total_chunks, seed=exp.data.seed,
        noise=exp.data.noise, n_attrs=exp.data.n_attrs,
        options=exp.data.source_options, drift_option=spec.drift_option,
        drift_start=spec.drift_start, drift_end=spec.drift_end, device=dev,
        dtype=ing.dtype)

    state = ing.init_state()
    start_chunk = 0
    if resume:
        if checkpoint_dir is None:
            raise ValueError("resume=True needs a checkpoint_dir to "
                             "restore from")
        state, step = restore_stream(checkpoint_dir, like=state)
        if step % spec.chunk != 0:
            raise ValueError(
                f"checkpoint step {step} is not chunk-aligned "
                f"(chunk={spec.chunk}) — was it saved by a different spec?")
        start_chunk = step // spec.chunk

    # crash-degraded serving: publish the survivor mask (as of the last
    # completed sweep round) with every weight refresh
    fl = ing.cfg.transport.faults if ing.cfg.transport is not None else None
    crashes = fl is not None and bool(fl.crash)
    d = len(ing.groups)

    def publish(state: StreamState) -> None:
        alive = (torch.tensor(faults_trace.alive_at(fl, d, int(state.rounds) - 1),
                              dtype=torch.bool, device=dev) if crashes else None)
        engine.update(state.params, state.weights, alive=alive)

    if engine is not None:
        publish(state)
        engine.warmup()

    records: List[Dict[str, Any]] = []
    with obs_span("stream.fit", total_instances=spec.total_instances,
                  chunk=spec.chunk, resweep_every=spec.resweep_every), \
            sanitize.error_scope(exp.backend.checks):
        for t in range(start_chunk, total_chunks):
            x, yc = source(t)
            state = ing.ingest(state, x, yc)
            if engine is not None:
                publish(state)
            count = (t + 1) * spec.chunk
            if count % spec.resweep_every == 0:
                rounds0 = int(state.rounds)
                with obs_span("stream.resweep", round=rounds0, count=count):
                    state, rec = ing.resweep(state)
                records.append(rec)
                obs_event("stream.record", round=rounds0, count=count,
                          sweeps=rec["sweeps"], eta=rec["eta"],
                          train_mse=rec["train_mse"],
                          preq_mse=rec["preq_mse"], bytes=rec["bytes"],
                          bytes_total=rec["bytes_total"])
                if crashes and obs_active():
                    # agents newly down over the rounds this resweep ran
                    for r in range(rounds0, int(state.rounds)):
                        before = np.asarray(faults_trace.alive_at(fl, d, r - 1))
                        after = np.asarray(faults_trace.alive_at(fl, d, r))
                        for i in np.nonzero(before & ~after)[0]:
                            obs_event("fault.crash", round=r, agent=int(i))
                if engine is not None:
                    publish(state)
            if (checkpoint_dir is not None
                    and spec.checkpoint_every is not None
                    and count % spec.checkpoint_every == 0):
                with obs_span("stream.checkpoint", step=count):
                    save_stream(checkpoint_dir, state)

    obs_norm = exp.obs.normalized()
    tap_stacks = [r["taps"] for r in records if r.get("taps")]
    metrics = None
    if obs_norm is not None and tap_stacks:
        merged = {k: np.concatenate([s[k] for s in tap_stacks])
                  for k in tap_stacks[0]}
        metrics = obs_taps.metrics_from_taps(obs_norm, merged)
    return StreamResult(spec=spec, family=ing.family, params=state.params,
                        weights=state.weights, records=records, state=state,
                        metrics=metrics, ingestor=ing)

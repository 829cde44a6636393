"""repro_torch.stream — online ICOA on the card: ingestion, cadenced
re-sweeps, live serving (twin of repro.stream).

    from repro_torch import api

    spec = api.StreamSpec(experiment=api.ExperimentSpec(...),
                          window=4096, chunk=64, resweep_every=2048)
    result = api.stream_fit(spec)        # records: train/preq MSE, eta, bytes

Three pillars:
  * ingest  — `Ingestor` + `StreamState` (ingest.py): a fixed-capacity ring
    buffer over the instance axis, rank-1 Sherman–Morrison commits into the
    warm CovState (core.covstate.replace_col), prequential scoring.
  * serve   — `PredictEngine` (serve.py): bucketed batch predict against
    the live combination weights, one latency ring per bucket.
  * elastic — checkpoint/restore of the whole live state (checkpoint.py),
    in the JAX package's layout; arrivals are pure in (seed, chunk), so
    restarts resume bit for bit.
"""
from __future__ import annotations

from repro_torch.stream.checkpoint import (CheckpointError, latest_stream_step,
                                           restore_stream, save_stream)
from repro_torch.stream.ingest import Ingestor, StreamState
from repro_torch.stream.run import StreamResult, build_ingestor, stream_fit
from repro_torch.stream.serve import PredictEngine
from repro_torch.stream.source import ChunkSource

__all__ = [
    "CheckpointError", "ChunkSource", "Ingestor", "PredictEngine",
    "StreamResult", "StreamState", "build_ingestor", "latest_stream_step",
    "restore_stream", "save_stream", "stream_fit",
]

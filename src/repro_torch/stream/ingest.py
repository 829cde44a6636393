"""Online ingestion: a fixed-capacity ring buffer over the instance axis
(twin of repro.stream.ingest).

The offline solver consumes a frozen (D, N) prediction matrix; here
instances arrive.  `StreamState` is the complete live state of an online
ICOA process, with the JAX package's fields in its order, so it
checkpoints as a unit into the JAX package's layout (stream.checkpoint).
`Ingestor` drives it with two operations:

    ingest(state, x, y)   one `chunk`-sized micro-batch: prequential predict
                          (score before the instances are seen — the
                          stream's test metric), then commit each instance
                          into the window ring (covstate.replace_cols' two
                          Sherman–Morrison steps, O(D^2) per arrival, no
                          pass over the window) and refresh the live
                          combination weights from the warm CovState.
    resweep(state)        the cadenced training step: slice the filled
                          prefix of the window, run `sweeps_per_resweep`
                          icoa.sweep calls on the warm params (any engine;
                          the transport ledger meters the bytes), record a
                          history entry, write the swept predictions back
                          and rebuild the CovState (the once-per-resweep
                          full solve that bounds the rank-1 drift).

The ring index, the count, the live flag and the fault round are host
integers (numpy int32, the JAX package's int32 scalars in a checkpoint),
so `ingest` never reads the card: a chunk's slots are contiguous (the
window is a multiple of the chunk), its ring writes are slice copies,
and the prequential error accumulates on the device.  Both
operations consume the state they are given — its window buffers are
updated in place — and return the next one.

Key discipline mirrors core.icoa.run: the first resweep re-inits from
`icoa.init_state` on the window with split(PRNGKey(seed), D), the key
stream starts from PRNGKey(seed + 1), then `key, k1, k2 = split(key, 3)`
per sweep (the key is carried at alpha = 1 too: it is part of the state),
and the sweeps stop at the eps rule — so a stream whose window holds
exactly an offline training set reproduces `api.fit`'s history.

Cold start: before the first resweep the CovState is built from an
all-zero window, so the state carries a `live` flag and serves uniform
weights until the first resweep's rebuild; the rank-1 commits keep a0 and
r_sub exact throughout, which is all the rebuild reads.  Under a crash
schedule the live weights are the survivors' (ensemble.surviving_weights,
alive as of the last completed sweep round).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.analysis import sanitize
from repro_torch.core import covstate, ensemble, icoa
from repro_torch.core.icoa import ICOAConfig
from repro_torch.core.tree import tree_map
from repro_torch.faults import trace as faults_trace
from repro_torch.obs import health as obs_health
from repro_torch.obs import taps as obs_taps
from repro_torch.transport import Ledger

__all__ = ["StreamState", "Ingestor"]


class StreamState(NamedTuple):
    """The complete live state of one online ICOA process.

    Window arrays have a fixed capacity of `window` slots; slots beyond
    `count` hold zeros — a zero residual column is inert in the Gram and
    its Sherman–Morrison downdate is an exact no-op, so append and
    evict-replace are one operation."""

    params: Any              # stacked agent params, leading dim D
    xcols: torch.Tensor      # (D, W, C) per-agent column views of the window
    y: torch.Tensor          # (W,) outcomes (zeros beyond the filled prefix)
    f: torch.Tensor          # (D, W) per-agent predictions on the window
    cov: covstate.CovState   # warm covariance state, r_sub (D, W)
    weights: torch.Tensor    # (D,) live combination weights being served
    cursor: np.int32         # next ring slot to write
    count: np.int32          # total instances ever ingested
    live: np.int32           # 1 after the first resweep's refresh
    key: torch.Tensor        # (2,) sweep key carry (core.icoa.run discipline)
    ledger: Ledger           # cumulative measured re-sweep wire bytes
    preq_sse: torch.Tensor   # () prequential squared-error sum since record
    preq_n: np.int32         # prequential instance count since record
    rounds: np.int32         # global sweep counter: the fault round, so a
    #                          restored stream replays the same fault trace


class Ingestor:
    """Absorbs (x, y) arrivals and keeps the per-agent CovState warm.

    `groups` is the attribute partition (DataSpec.groups); arrivals come as
    full-attribute rows `x : (chunk, n_attrs)` and are sliced into
    per-agent column views here.  `cfg` must be an alpha = 1, delta = 0
    ICOAConfig (StreamSpec.validate enforces this): the window CovState
    tracks full-window residuals and the live weights are the closed form
    s / sum(s).  The state lives on `device` (the card unless the caller
    asks for the CPU), in torch's default float dtype at construction;
    ingest and resweep compute float32 products in full fp32 (TF32 off),
    as icoa.run does.  Under cfg.checks="raise" the check sites of both
    fold into the run's error word (stream_fit's), or into the Ingestor's
    own; `resweep` reads it at its end, where it has waited on the device
    anyway, and raises analysis.CheckError on a failure."""

    def __init__(self, family, groups: Sequence[Sequence[int]],
                 cfg: ICOAConfig, window: int, chunk: int, seed: int = 0,
                 sweeps_per_resweep: int = 1, device="cuda"):
        from repro_torch.api.runner import resolve_device   # api imports us

        if window % chunk != 0:
            raise ValueError(f"window={window} must be a multiple of "
                             f"chunk={chunk} (chunks must never straddle the "
                             f"ring's wrap point)")
        if cfg.alpha != 1.0 or cfg.delta != 0.0:
            raise ValueError("streaming CovState is the alpha=1/delta=0 "
                             "path (see StreamSpec.validate)")
        self.family = family
        self.groups = [list(g) for g in groups]
        self.cfg = cfg
        self.window = window
        self.chunk = chunk
        self.seed = seed
        self.sweeps_per_resweep = sweeps_per_resweep
        self.device = resolve_device(device, "repro_torch.stream.Ingestor")
        self.dtype = torch.get_default_dtype()
        self._d = len(self.groups)
        self._cols = len(self.groups[0])
        self._fl = cfg.transport.faults if cfg.transport is not None else None
        self._crashes = self._fl is not None and bool(self._fl.crash)
        self._gidx = torch.tensor(self.groups, dtype=torch.int64,
                                  device=self.device)
        self._init_keys = icoa.init_keys(seed, self._d, self.device)
        # host-side runtime health (obs.health): counted outside the device
        # work, whether or not anyone reads them
        self.counters = {
            "ingest_chunks": obs_health.Counter(),
            "ingest_instances": obs_health.Counter(),
            "resweeps": obs_health.Counter(),
            "resweep_sweeps": obs_health.Counter(),
        }
        self.last_preq_mse = float("nan")  # prequential MSE of the last record
        self._errors = (sanitize.ErrorWord() if cfg.checks == "raise"
                        else None)

    # ------------------------------------------------------------- lifecycle

    @icoa._full_fp32
    def init_state(self) -> StreamState:
        """Empty-window state — also the restore template (its dtypes are
        the ones checkpoints restore into)."""
        dt, dev = self.dtype, self.device
        d, w, c = self._d, self.window, self._cols
        params = tree_map(lambda t: t.to(dt), self.family.init(self._init_keys, dt))
        xcols = torch.zeros((d, w, c), dtype=dt, device=dev)
        y = torch.zeros((w,), dtype=dt, device=dev)
        f = self.family.predict(params, xcols)
        return StreamState(
            params=params, xcols=xcols, y=y, f=f,
            cov=covstate.build(y[None, :] - f),
            weights=torch.full((d,), 1.0 / d, dtype=dt, device=dev),
            cursor=np.int32(0), count=np.int32(0), live=np.int32(0),
            key=prng.PRNGKey(self.seed + 1, device=dev),
            ledger=Ledger(),
            preq_sse=torch.zeros((), dtype=dt, device=dev),
            preq_n=np.int32(0), rounds=np.int32(0))

    # --------------------------------------------------------------- ingest

    def slice_groups(self, x: torch.Tensor) -> torch.Tensor:
        """(n, n_attrs) -> (D, n, C) per-agent column views (one gather)."""
        return x[:, self._gidx].permute(1, 0, 2)

    def _alive(self, round_: int) -> torch.Tensor:
        return torch.tensor(faults_trace.alive_at(self._fl, self._d, round_),
                            dtype=torch.bool, device=self.device)

    @icoa._full_fp32
    def ingest(self, state: StreamState, x: torch.Tensor,
               y_chunk: torch.Tensor) -> StreamState:
        """Absorb one (chunk, n_attrs) / (chunk,) micro-batch."""
        with sanitize.error_scope(self.cfg.checks, word=self._errors):
            return self._ingest(state, x, y_chunk)

    def _ingest(self, state: StreamState, x: torch.Tensor,
                y_chunk: torch.Tensor) -> StreamState:
        self.counters["ingest_chunks"].add(1)
        self.counters["ingest_instances"].add(self.chunk)
        n = self.chunk
        j0 = int(state.cursor)
        xc = self.slice_groups(x)                              # (D, chunk, C)
        preds = self.family.predict(state.params, xc)          # (D, chunk)
        # prequential: score with the weights being served, before ingesting
        yhat = ensemble.combine(state.weights, preds)
        preq_sse = state.preq_sse + torch.sum((y_chunk - yhat) ** 2)

        # the chunk's commits: the arriving residual columns in, the
        # evicted slots' out, two Sherman–Morrison steps an arrival
        cov = covstate.replace_cols(state.cov, j0, y_chunk[None, :] - preds)
        state.xcols[:, j0:j0 + n] = xc
        state.y[j0:j0 + n] = y_chunk
        state.f[:, j0:j0 + n] = preds

        # live weights off the warm solve state; uniform until the first
        # resweep's rebuild makes the solve state meaningful
        if int(state.live) > 0:
            if self._crashes:
                w_live = ensemble.surviving_weights(
                    cov.a0, self._alive(int(state.rounds) - 1))
            else:
                w_live = cov.s / torch.sum(cov.s)
            weights = w_live.to(state.weights.dtype)
        else:
            weights = torch.full((self._d,), 1.0 / self._d,
                                 dtype=state.weights.dtype, device=self.device)
        return state._replace(
            cov=cov, weights=weights,
            cursor=np.int32((j0 + n) % self.window),
            count=np.int32(int(state.count) + n),
            preq_sse=preq_sse, preq_n=np.int32(int(state.preq_n) + n))

    # -------------------------------------------------------------- resweep

    def _record(self, params, f, yw, k2, alive=None):
        """Post-sweep record: weights, window train MSE, eta, and the record
        taps off the same Gram (core.icoa's record)."""
        w = icoa._weights(f, yw, self.cfg, k2, alive)
        train = torch.mean((yw - ensemble.combine(w, f)) ** 2)
        eta, rtaps = icoa._record_eta(self.cfg, yw[None, :] - f)
        return w, train, eta, rtaps

    @icoa._full_fp32
    def resweep(self, state: StreamState) -> Tuple[StreamState, Dict[str, Any]]:
        """Run the cadenced training step on the warm window; returns the
        refreshed state and one history record (host values)."""
        with sanitize.error_scope(self.cfg.checks, word=self._errors) as word:
            out = self._resweep(state)
            if word is not None:
                word.throw()
        return out

    def _resweep(self, state: StreamState) -> Tuple[StreamState, Dict[str, Any]]:
        count = int(state.count)
        if count == 0:
            raise ValueError("resweep on an empty window — ingest first")
        filled = min(count, self.window)
        xw = state.xcols[:, :filled]
        yw = state.y[:filled]

        if not int(state.live):
            # first resweep: the offline non-cooperative warm start, same key
            # discipline as icoa.run — records from here match api.fit
            st0 = icoa.init_state(self.family, xw, yw, self._init_keys)
            params, f = st0.params, st0.f
            key = prng.PRNGKey(self.seed + 1, device=self.device)
        else:
            params, f = state.params, state.f[:, :filled]
            key = state.key

        ledger = state.ledger
        bytes0 = ledger.spent
        rounds0 = int(state.rounds)
        etas: List[float] = []
        eta_prev = math.inf
        tap_rows: List[Dict[str, Any]] = []
        w = train = None                 # sweeps_per_resweep >= 1 sets them
        for j in range(self.sweeps_per_resweep):
            key, k1, k2 = prng.split(key, 3).unbind(-2)
            rnd = rounds0 + j
            params, f, ledger, etps = icoa.sweep(self.family, self.cfg, params,
                                                 f, xw, yw, k1, ledger, rnd)
            alive = self._alive(rnd) if self._crashes else None
            w, train, eta, rtps = self._record(params, f, yw, k2, alive)
            eta_now = float(eta)
            etas.append(eta_now)
            if self.cfg.obs is not None:
                tap_rows.append({**etps, **rtps})
            if abs(eta_prev - eta_now) < self.cfg.eps:
                break
            eta_prev = eta_now

        # write the swept predictions back and rebuild the CovState: the
        # full solve bounding the rank-1 drift (plain products)
        state.f[:, :filled] = f
        cov = covstate.build(state.y[None, :] - state.f)
        preq_n = int(state.preq_n)
        preq_mse = float(state.preq_sse) / preq_n if preq_n else float("nan")
        self.counters["resweeps"].add(1)
        self.counters["resweep_sweeps"].add(len(etas))
        self.last_preq_mse = preq_mse
        record = {
            "count": count,
            "filled": filled,
            "train_mse": float(train),
            "preq_mse": preq_mse,
            "preq_n": preq_n,
            "eta": etas[-1],
            "etas": etas,
            "sweeps": len(etas),
            "bytes": ledger.spent - bytes0,
            "bytes_total": ledger.spent,
            # one tap row per executed sweep, {} without taps
            "taps": obs_taps.stack_tap_rows(tap_rows),
        }
        state = state._replace(
            params=params, cov=cov, weights=w, key=key, ledger=ledger,
            live=np.int32(1), preq_sse=torch.zeros_like(state.preq_sse),
            preq_n=np.int32(0), rounds=np.int32(rounds0 + len(etas)))
        return state, record

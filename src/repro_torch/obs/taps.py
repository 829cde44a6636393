"""Tap collection helpers for the sweep engines, and the host-side Metrics
container (twin of repro.obs.taps).

Every helper is a no-op when its tap is not selected: the gate is a Python
`if` on the ObsSpec, so the off mode adds no device operation.  A tap only
reads values the engine already has, so turning taps on changes no result.
A sweep's tap dict maps a name to its value for that sweep: a device
tensor (accepts, codec_error, the record's eta and s) or, for the two
counters, a numpy int32 — every budget gate and the fault trace of a sweep
are settled on the host at its start (transport.policy.gate_schedule,
faults.inject.RoundTrace), so the counters never wait for the device.  A
batched sweep gives each value a leading trial axis.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.trial_index import put
from repro_torch.obs.spec import TAPS, ObsSpec

__all__ = ["Metrics", "engine_taps", "tap_accept", "tap_gates",
           "record_taps", "stack_tap_rows", "metrics_from_taps"]


def _on(obs: Optional[ObsSpec], name: str) -> bool:
    return obs is not None and name in obs.taps


def _codec_error(sent: torch.Tensor, received: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """||received - sent|| / ||sent|| (Frobenius, per trial for (B, D, m)),
    in the run's float dtype."""
    sent, received = sent.to(dtype), received.to(dtype)
    dims = (-2, -1)
    num = torch.sqrt(torch.sum((received - sent) ** 2, dim=dims))
    den = torch.sqrt(torch.sum(sent ** 2, dim=dims))
    return num / (den + 1e-30)


def engine_taps(obs: Optional[ObsSpec], like: torch.Tensor,
                sent: Optional[torch.Tensor] = None,
                received: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """The engine-side taps of one sweep at its start, for the prediction
    matrix `like` ((D, N), or (B, D, N) for a batch): zeroed accepts and
    counters in the JAX package's order, and the codec's round-trip error
    of the sweep-start gather (`sent` as it left the agents, `received` as
    the relay delivered it)."""
    taps: Dict[str, Any] = {}
    if obs is None:
        return taps
    lead = like.shape[:-2]
    if "accepts" in obs.taps:
        taps["accepts"] = torch.zeros((*lead, like.shape[-2]), dtype=like.dtype,
                                      device=like.device)
    for name in ("budget_rejects", "fault_retries"):
        if name in obs.taps:
            taps[name] = np.zeros(lead, np.int32)
    if "codec_error" in obs.taps:
        taps["codec_error"] = _codec_error(sent, received, like.dtype)
    return taps


def tap_accept(taps: Dict[str, Any], obs: Optional[ObsSpec], i, accept
               ) -> None:
    """Record agent i's final commit acceptance (after the budget and fault
    gates): agent i an int, or one per trial ((B,) device index)."""
    if not _on(obs, "accepts"):
        return
    acc = taps["accepts"]
    put(acc, i, acc.dim() - 1, accept.to(acc.dtype))


def tap_gates(taps: Dict[str, Any], obs: Optional[ObsSpec], denied,
              retries) -> None:
    """The sweep's two counters from its host-settled gates: `denied`, the
    broadcasts the byte budget refused (an int, or B ints; counted on a
    budgeted run without faults only, as in the JAX package), and
    `retries`, the attempts beyond the first of every agent that was alive
    and not straggling (the fault trace's; one count for every trial)."""
    if _on(obs, "budget_rejects"):
        taps["budget_rejects"] = np.broadcast_to(
            np.asarray(denied, np.int32), taps["budget_rejects"].shape).copy()
    if _on(obs, "fault_retries"):
        taps["fault_retries"] = np.full(taps["fault_retries"].shape, retries,
                                        np.int32)


def record_taps(obs: Optional[ObsSpec], eta, s_vec) -> Dict[str, Any]:
    """Record-side taps from what the record already computed: `eta` the
    exact value the history records (so the tap equals History.eta bit for
    bit), `s_vec` the solve vector of the same Gram."""
    taps: Dict[str, Any] = {}
    if _on(obs, "eta"):
        taps["eta"] = eta
    if _on(obs, "s"):
        taps["s"] = s_vec
    return taps


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:          # numpy has no bfloat16
            v = v.float()
        return v.cpu().numpy()
    return np.asarray(v)


def stack_tap_rows(rows: Sequence[Mapping[str, Any]], axis: int = 0
                   ) -> Dict[str, np.ndarray]:
    """Host side: stack per-sweep tap dicts into arrays with a sweep axis
    at `axis` (1 for a batch's rows, behind the trial axis) — one
    device-to-host copy per tap."""
    if not rows:
        return {}
    out = {}
    for k in rows[0]:
        vals = [r[k] for r in rows]
        if isinstance(vals[0], torch.Tensor):
            out[k] = _host(torch.stack(vals, dim=axis))
        else:
            out[k] = np.stack([np.asarray(v) for v in vals], axis=axis)
    return out


@dataclasses.dataclass
class Metrics:
    """Stable-schema container for collected tap series (the JAX package's).

    `taps` maps tap name -> numpy array with a leading sweep axis:
    (n_sweeps,) for scalar taps, (n_sweeps, D) for per-agent taps — sweep k
    (0-based) corresponds to History record k+1 (record 0, the
    non-cooperative init, precedes any sweep).  In-memory only, like
    `Result.data`: never serialised by result io.
    """

    taps: Dict[str, np.ndarray]
    spec: ObsSpec

    def __getitem__(self, name: str) -> np.ndarray:
        return self.taps[name]

    def __contains__(self, name: str) -> bool:
        return name in self.taps

    @property
    def names(self) -> List[str]:
        return sorted(self.taps)

    @property
    def n_sweeps(self) -> int:
        return next(iter(self.taps.values())).shape[0] if self.taps else 0

    def as_dict(self) -> Dict[str, Any]:
        """JSON-ready view: {name: {values, axes, dtype, desc}}."""
        return {k: {"values": np.asarray(v).tolist(),
                    "axes": list(("sweep",) + tuple(TAPS[k]["axes"])),
                    "dtype": str(np.asarray(v).dtype),
                    "desc": TAPS[k]["desc"]}
                for k, v in self.taps.items()}


def metrics_from_taps(obs: Optional[ObsSpec], taps: Optional[Mapping[str, Any]]
                      ) -> Optional[Metrics]:
    """Stacked host tap arrays -> Metrics (None when obs is off)."""
    if obs is None or not obs.enabled or not taps:
        return None
    return Metrics(taps={k: np.asarray(v) for k, v in taps.items()}, spec=obs)

"""repro_torch.transport — the measured communication layer.

Twin of repro.transport: topologies (full, ring, star, random_graph),
codecs (exact_f64 / f32 / bf16, int8_affine, topk_sparse), the host-side
byte ledger and the byte-budget policies (truncate, greedy_eta).
`Transport` bundles one topology, codec and budget and provides the relays
the sweeps call: a broadcast from agent i reaches the farthest agent after
ecc[i] decode/re-encode hops, so the shared covariance state holds the
roundtrip^ecc view of each row — the identity for an exact codec that
holds the data dtype.  The `_st` relays pass gradients straight through
the codec at every hop (the dense engine differentiates its objective
through the payload).  A FaultSpec (repro_torch.faults) rides on the
Transport; an inert one is normalised to None, so the zero-fault sweep is
the plain one, launch for launch.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.analysis import sanitize
from repro_torch.faults.spec import FaultSpec
from repro_torch.transport.codecs import (CODECS, Codec, ExactCodec,
                                          Int8AffineCodec, TopKSparseCodec,
                                          build_codec, register_codec)
from repro_torch.transport.ledger import (Ledger, TrialLedgers,
                                          agent_broadcast_cost, gather_cost,
                                          icoa_sweep_cost, refit_cycle_bytes)
from repro_torch.transport.policy import (POLICIES, budget_setup,
                                          gate_broadcast, gate_schedule,
                                          greedy_order, require_budget_engine)
from repro_torch.transport.topology import (TOPOLOGIES, Topology,
                                            TransportError, build_topology,
                                            register_topology)

__all__ = [
    "CODECS", "Codec", "ExactCodec", "FaultSpec", "Int8AffineCodec", "Ledger",
    "POLICIES",
    "TOPOLOGIES", "Topology", "TopKSparseCodec", "Transport", "TransportError",
    "TrialLedgers", "agent_broadcast_cost", "budget_setup", "build_codec",
    "build_topology", "default_transport", "gate_broadcast", "gate_schedule",
    "gather_cost", "greedy_order", "icoa_sweep_cost", "refit_cycle_bytes",
    "register_codec", "register_topology", "require_budget_engine",
]


@dataclasses.dataclass(frozen=True)
class Transport:
    """One resolved communication regime (topology + codec + budget, and
    the failure model: None is the reliable wire)."""

    topology: Topology
    codec: Codec
    byte_budget: Optional[float] = None
    policy: str = "greedy_eta"
    faults: Optional[FaultSpec] = None

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise TransportError(
                f"unknown budget policy {self.policy!r}; pick one of {POLICIES}")
        if self.byte_budget is not None and not (
                math.isfinite(self.byte_budget) and self.byte_budget > 0):
            raise TransportError(
                f"byte_budget must be positive and finite (got "
                f"{self.byte_budget}); use None for unbudgeted runs")
        if self.faults is not None:
            self.faults.validate()
            if self.faults.is_inert:
                # an inject-nothing spec is the reliable wire
                object.__setattr__(self, "faults", None)

    def _st(self, x: torch.Tensor) -> torch.Tensor:
        """One straight-through hop: the delivered value, the identity's
        gradient (x + sg(roundtrip(x) - x), the JAX package's form)."""
        return x + (self.codec.roundtrip(x) - x).detach()

    def _relay(self, x: torch.Tensor, ecc, rt) -> torch.Tensor:
        """x after `ecc` hops of rt: a Python int for one payload (the hop
        applied ecc times), the per-row tuple for a (..., D, m) matrix, or
        a (B,) device tensor of hop counts for one payload per trial (both
        selected hop by hop).  The identity check comes first, so an exact
        codec costs nothing."""
        if self.codec.is_identity_for(x.dtype):
            return x
        if isinstance(ecc, int):
            for _ in range(ecc):
                x = rt(x)
        else:
            hops = (ecc if isinstance(ecc, torch.Tensor)
                    else _on_device(ecc, x.device))[:, None]
            for h in range(self.topology.max_ecc):
                x = torch.where(hops > h, rt(x), x)
        # only lossy payloads reach here: a NaN or inf delivered out of the
        # relay poisons the shared state a sweep later, far from its source
        return sanitize.check_finite(
            x, f"transport relay: codec {self.codec.name!r} delivered a "
            f"non-finite payload over topology {self.topology.name!r}")

    def relay_rows(self, r: torch.Tensor) -> torch.Tensor:
        """(..., D, m) -> the same: row i as received after ecc[i] hops."""
        return self._relay(r, self.topology.ecc, self.codec.roundtrip)

    def relay_rows_st(self, r: torch.Tensor) -> torch.Tensor:
        """`relay_rows` with straight-through gradients, hop by hop."""
        return self._relay(r, self.topology.ecc, self._st)

    def relay_scalars(self, v: torch.Tensor) -> torch.Tensor:
        """(..., D) per-agent scalars, each flooded from its own agent."""
        if self.codec.is_identity_for(v.dtype):
            return v
        return self.relay_rows(v[..., None])[..., 0]

    def relay_scalars_st(self, v: torch.Tensor) -> torch.Tensor:
        """`relay_scalars` with straight-through gradients."""
        if self.codec.is_identity_for(v.dtype):
            return v
        return self.relay_rows_st(v[..., None])[..., 0]

    def _ecc_of(self, i):
        """Hops of agent i's broadcast: an int, or per trial for a (B,)
        device index."""
        if isinstance(i, torch.Tensor):
            return _on_device(self.topology.ecc, i.device)[i]
        return self.topology.ecc[i]

    def relay_row(self, row: torch.Tensor, i) -> torch.Tensor:
        """One row broadcast from agent i (one per trial, (B, m), from
        agent i or from each trial's own agent i (B,))."""
        return self._relay(row, self._ecc_of(i), self.codec.roundtrip)

    def relay_scalar(self, v: torch.Tensor, i) -> torch.Tensor:
        """A per-row scalar (or one per trial, (B,)) rides the same relay as
        its row, as a payload of its own."""
        if self.codec.is_identity_for(v.dtype):
            return v
        return self.relay_row(v[..., None], i)[..., 0]

    def broadcast_costs(self, m: int, split: bool) -> Tuple[int, ...]:
        """The D agents' flood prices — the budget gate indexes them by the
        (possibly reordered) updating agent."""
        return tuple(agent_broadcast_cost(self, i, m, split)
                     for i in range(self.topology.n_agents))

    def validate_for(self, n_agents: int) -> "Transport":
        if self.topology.n_agents != n_agents:
            raise TransportError(
                f"transport topology {self.topology.name!r} was built for "
                f"{self.topology.n_agents} agents but the run has {n_agents}")
        if self.faults is not None:
            for agent, _, _ in self.faults.crash:
                if agent >= n_agents:
                    raise TransportError(
                        f"faults.crash names agent {agent} but the run has "
                        f"{n_agents} agents")
        return self


@functools.lru_cache(maxsize=None)
def _on_device(ecc: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """A topology's hop counts as a device tensor, copied there once."""
    return torch.tensor(ecc, dtype=torch.int64, device=device)


@functools.lru_cache(maxsize=None)
def default_transport(n_agents: int) -> Transport:
    """Lossless f64 payloads on a complete graph — every run's default.
    Built once per agent count: the topology's BFS tables cost O(D^3) host
    time, and a Transport is immutable."""
    return Transport(topology=build_topology("full", n_agents),
                     codec=build_codec("exact_f64"))

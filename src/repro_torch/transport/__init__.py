"""repro_torch.transport — the measured communication layer, default path.

Twin of repro.transport for this slice: the `full` topology, the exact
codecs and the host-side byte ledger.  `Transport` bundles one topology and
codec and provides the relays the sweeps call: a broadcast from agent i
reaches the farthest agent after ecc[i] decode/re-encode hops, so the shared
covariance state holds the roundtrip^ecc view of each row — the identity for
an exact codec that holds the data dtype.  The `_st` relays pass gradients
straight through the codec (the dense engine differentiates its objective
through the payload).  Byte budgets, budget policies and faults wait for
ROADMAP A9 and A12.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.transport.codecs import (CODECS, Codec, ExactCodec,
                                          build_codec, register_codec)
from repro_torch.transport.ledger import (Ledger, agent_broadcast_cost,
                                          gather_cost, icoa_sweep_cost,
                                          refit_cycle_bytes)
from repro_torch.transport.topology import (TOPOLOGIES, Topology,
                                            TransportError, build_topology,
                                            register_topology)

__all__ = [
    "CODECS", "Codec", "ExactCodec", "Ledger", "TOPOLOGIES", "Topology",
    "Transport", "TransportError", "agent_broadcast_cost", "build_codec",
    "build_topology", "default_transport", "gather_cost", "icoa_sweep_cost",
    "refit_cycle_bytes", "register_codec", "register_topology",
]


@dataclasses.dataclass(frozen=True)
class Transport:
    """One resolved communication regime (topology + codec)."""

    topology: Topology
    codec: Codec

    def _relay(self, x: torch.Tensor, ecc) -> torch.Tensor:
        """x after `ecc` decode/re-encode hops: an int for one row, the
        per-row tuple for a (D, m) matrix.  The identity check comes first,
        so an exact codec costs no host-to-device copy (and no wait)."""
        if self.codec.is_identity_for(x.dtype):
            return x
        hops = torch.as_tensor(ecc, device=x.device)
        if hops.dim() == 1:
            hops = hops[:, None]
        for h in range(self.topology.max_ecc):
            x = torch.where(hops > h, self.codec.roundtrip(x), x)
        return x

    def relay_rows(self, r: torch.Tensor) -> torch.Tensor:
        """(D, m) -> (D, m): row i as received after ecc[i] relay hops."""
        return self._relay(r, self.topology.ecc)

    def relay_rows_st(self, r: torch.Tensor) -> torch.Tensor:
        """`relay_rows` with straight-through gradients: the delivered
        value, the identity's gradient."""
        if self.codec.is_identity_for(r.dtype):
            return r
        return r + (self.relay_rows(r) - r).detach()

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

    def relay_row(self, row: torch.Tensor, i: int) -> torch.Tensor:
        """One row broadcast from agent i."""
        return self._relay(row, self.topology.ecc[i])

    def relay_scalar(self, v: torch.Tensor, i: int) -> torch.Tensor:
        """A per-row scalar (or one per trial, (B,)) rides the same relay as
        its row, as a payload of its own."""
        if self.codec.is_identity_for(v.dtype):
            return v
        return self.relay_row(v[..., None], i)[..., 0]

    def validate_for(self, n_agents: int) -> "Transport":
        if self.topology.n_agents != n_agents:
            raise TransportError(
                f"transport topology {self.topology.name!r} was built for "
                f"{self.topology.n_agents} agents but the run has {n_agents}")
        return self


@functools.lru_cache(maxsize=None)
def default_transport(n_agents: int) -> Transport:
    """Lossless f64 payloads on a complete graph — every run's default.
    Built once per agent count: the topology's BFS tables cost O(D^3) host
    time, and a Transport is immutable."""
    return Transport(topology=build_topology("full", n_agents),
                     codec=build_codec("exact_f64"))

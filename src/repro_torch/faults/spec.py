"""FaultSpec — the declarative, replayable failure model (twin of
repro.faults.spec, field for field and check for check).

One frozen dataclass describes what can go wrong on the wire: link drops
with a bounded retry policy, payload bit-flip corruption, stragglers and
agent crash/rejoin schedules.  It is the only source of fault randomness:
every event is drawn from `PRNGKey(seed)` folded with an event tag, the
sweep round and the agent (faults.trace), never from the solver's key
stream, so a trace is pure in (seed, round, agent) and replays bit for bit
across engines, Monte-Carlo trials and devices.

`max_retries` is the resilience knob: 0 = drop and skip (a lost broadcast
forfeits the agent's commit that round), k > 0 = up to k retransmissions,
every attempt charged to the byte ledger.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = ["FaultError", "FaultSpec"]


class FaultError(ValueError):
    """A FaultSpec field is out of range or malformed."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Seeded, replayable fault injection at the transport boundary.

    crash entries are (agent, down_round, rejoin_round) triples: the agent
    is dead for rounds down_round <= r < rejoin_round (rejoin_round < 0:
    it never rejoins).  A dead agent transmits nothing — its gather row is
    its last delivered state, its commits are skipped, and the served
    ensemble re-weights over the survivors (`ensemble.surviving_weights`).
    Every sweep rebuilds the covariance state from the carried predictions,
    so a rejoined agent re-enters with its pre-crash row.
    """

    seed: int = 0               # fault-trace seed (independent of the solver's)
    drop_rate: float = 0.0      # P(one broadcast attempt is lost on the wire)
    corrupt_rate: float = 0.0   # P(a delivered payload arrives bit-flipped)
    corrupt_bits: int = 8       # low mantissa bits a corruption may flip
    straggle_rate: float = 0.0  # P(an agent misses the round's commit window)
    max_retries: int = 0        # retransmissions after a dropped broadcast
    crash: Tuple[Tuple[int, int, int], ...] = ()   # (agent, down, rejoin)

    @property
    def is_inert(self) -> bool:
        """True when this spec injects nothing: the zero-fault path
        (Transport normalises an inert spec to None)."""
        return (self.drop_rate == 0.0 and self.corrupt_rate == 0.0
                and self.straggle_rate == 0.0 and not self.crash)

    def validate(self) -> None:
        for name in ("drop_rate", "corrupt_rate", "straggle_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise FaultError(
                    f"{name} is a probability, must be in [0, 1] (got {v})")
        if self.max_retries < 0:
            raise FaultError(
                f"max_retries must be >= 0 (got {self.max_retries})")
        if self.corrupt_bits < 1:
            raise FaultError(
                f"corrupt_bits must be >= 1 (got {self.corrupt_bits})")
        for pos, entry in enumerate(self.crash):
            if len(entry) != 3:
                raise FaultError(
                    f"crash[{pos}] must be an (agent, down_round, "
                    f"rejoin_round) triple (got {entry!r})")
            agent, down, rejoin = entry
            if agent < 0:
                raise FaultError(
                    f"crash[{pos}]: agent index must be >= 0 (got {agent})")
            if down < 0:
                raise FaultError(
                    f"crash[{pos}]: down_round must be >= 0 (got {down})")
            if 0 <= rejoin <= down:
                raise FaultError(
                    f"crash[{pos}]: rejoin_round {rejoin} must be after "
                    f"down_round {down} (or < 0 for a permanent crash)")

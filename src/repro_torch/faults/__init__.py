"""repro_torch.faults — deterministic fault injection (twin of
repro.faults).

    spec     `FaultSpec`, the frozen failure model (drops with bounded
             retry, bit-flip corruption, stragglers, crash/rejoin)
    trace    the seeded event draws: every failure is a pure function of
             (FaultSpec.seed, event tag, round, agent) via the JAX
             package's fold_in chains, so traces replay bit for bit
    inject   the sweep-side gates of the incremental and fused engines:
             measured retransmission bytes, skipped dead / straggling /
             undelivered commits

The zero-fault path costs nothing: `Transport` normalises an inert
FaultSpec to None, and every injection site is an `if` on it.
"""
from repro_torch.faults.inject import (RoundTrace, gate_broadcast,
                                       gate_schedule, require_fault_engine)
from repro_torch.faults.spec import FaultError, FaultSpec
from repro_torch.faults.trace import (Strikes, alive_at, broadcast_outcome,
                                      corrupt, corrupt_hits, straggles)

__all__ = ["FaultError", "FaultSpec", "RoundTrace", "Strikes", "alive_at",
           "broadcast_outcome", "corrupt", "corrupt_hits", "gate_broadcast",
           "gate_schedule", "require_fault_engine", "straggles"]

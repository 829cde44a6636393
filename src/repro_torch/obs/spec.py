"""ObsSpec — the static, hashable tap selection (twin of repro.obs.spec).

A tap is a named per-sweep scalar (or per-sweep/per-agent vector) collected
inside the sweep and surfaced as `Result.metrics` / `StreamResult.metrics`.
The selection rides the experiment spec and the `ICOAConfig` of the run, so
turning taps on or off is decided before the sweep runs:

  * off (the default, `taps=()`): not one device operation is added — every
    tap site is a Python `if` on the spec;
  * on: each selected tap only reads values the engine already has, so the
    history is the same, bit for bit.

The registry below is the JAX package's schema: names, shapes (per sweep),
dtype class and the stacking semantics.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

__all__ = ["ObsSpec", "ObsError", "TAPS", "ALL_TAPS"]


class ObsError(ValueError):
    """An ObsSpec names an unknown tap or is inconsistent."""


# The tap registry: name -> (axes, dtype class, description).  `axes` is the
# per-sweep shape: () is a scalar per sweep, ("agent",) a (D,) vector per
# sweep.  Stacking semantics are uniform for every tap:
#   * run/run_scan:   a leading (n_sweeps,) axis (record 0 — the
#                     non-cooperative init — has no sweep and no tap row);
#   * batch_fit:      a leading (n_trials,) axis in front of that;
#   * stream resweep: one row per executed sweep, concatenated across
#                     cadence periods in record order.
TAPS: Dict[str, Dict[str, object]] = {
    "eta": {
        "axes": (),
        "dtype": "float",
        "desc": "post-sweep ensemble eta (= 1/eta_tilde), the recorded "
                "objective — matches History.eta[1:] bit-for-bit",
    },
    "s": {
        "axes": ("agent",),
        "dtype": "float",
        "desc": "post-sweep solve vector A^{-1} 1 of the record-time "
                "residual Gram (normalising it gives the optimal weights; "
                "sum(s) = eta_tilde)",
    },
    "accepts": {
        "axes": ("agent",),
        "dtype": "float",
        "desc": "per-agent commit acceptance (1.0 = the agent's projected "
                "row committed, 0.0 = rejected or its broadcast was "
                "gated/dropped)",
    },
    "budget_rejects": {
        "axes": (),
        "dtype": "int32",
        "desc": "broadcasts denied by the byte-budget gate this sweep "
                "(budgeted fault-free runs; 0 when unbudgeted — under "
                "faults the budget folds into the fault gate and this "
                "tap stays 0)",
    },
    "fault_retries": {
        "axes": (),
        "dtype": "int32",
        "desc": "total retransmission attempts beyond the first across "
                "transmitting agents this sweep (recomputed from the "
                "deterministic fault trace; reconciles exactly with the "
                "ledger's retry byte charges on unbudgeted runs)",
    },
    "codec_error": {
        "axes": (),
        "dtype": "float",
        "desc": "relative Frobenius round-trip error of the codec relay on "
                "the sweep-start gathered residual payload "
                "(||relay(R) - R|| / ||R||; exactly 0 for exact codecs)",
    },
}

ALL_TAPS: Tuple[str, ...] = tuple(sorted(TAPS))

# taps whose accumulators live in the engine loop (vs the record step)
ENGINE_TAPS = ("accepts", "budget_rejects", "fault_retries", "codec_error")
RECORD_TAPS = ("eta", "s")


@dataclasses.dataclass(frozen=True)
class ObsSpec:
    """Which taps to collect.  Frozen + hashable: rides `ExperimentSpec.obs`
    and `ICOAConfig.obs`.  The empty default is the off mode: no tap site
    runs, the sweep is the tap-free one."""

    taps: Tuple[str, ...] = ()

    def validate(self) -> None:
        unknown = sorted(set(self.taps) - set(TAPS))
        if unknown:
            raise ObsError(
                f"unknown tap(s) {unknown}; registered: {list(ALL_TAPS)}")

    @property
    def enabled(self) -> bool:
        return bool(self.taps)

    def normalized(self) -> Optional["ObsSpec"]:
        """None when off; sorted-deduped otherwise — the canonical form
        threaded into ICOAConfig."""
        self.validate()
        if not self.taps:
            return None
        return ObsSpec(taps=tuple(sorted(set(self.taps))))

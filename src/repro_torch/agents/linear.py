"""Linear ridge agents — the degree-1 polynomial family (twin of
repro.agents.linear).

The weakest hypothesis space: ICOA cannot take the ensemble error below the
best additive-linear fit.  As a PolynomialFamily it takes the fused engine's
closed-form ridge projector, as in the JAX package.
"""
from __future__ import annotations

import dataclasses

from repro_torch.agents.polynomial import PolynomialFamily

__all__ = ["LinearFamily"]


@dataclasses.dataclass(frozen=True)
class LinearFamily(PolynomialFamily):
    degree: int = 1

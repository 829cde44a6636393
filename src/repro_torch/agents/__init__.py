"""Local estimator families — the hypothesis spaces H_i of the paper.

This slice ports the polynomial family; `linear` waits for ROADMAP A2 and
`mlp`/`rff` for A16 (see `NOT_PORTED`)."""
from repro_torch.agents.polynomial import PolynomialFamily

FAMILIES = {"polynomial": PolynomialFamily}

# families of the JAX package that are not ported yet -> the ROADMAP item
NOT_PORTED = {"linear": "A2", "mlp": "A16", "rff": "A16"}

__all__ = ["FAMILIES", "NOT_PORTED", "PolynomialFamily"]

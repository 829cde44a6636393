"""Local estimator families — the hypothesis spaces H_i of the paper.

This port holds the polynomial family and its degree-1 case, `linear`;
`mlp`/`rff` wait for ROADMAP A16 (see `NOT_PORTED`)."""
from repro_torch.agents.linear import LinearFamily
from repro_torch.agents.polynomial import PolynomialFamily

FAMILIES = {"polynomial": PolynomialFamily, "linear": LinearFamily}

# families of the JAX package that are not ported yet -> the ROADMAP item
NOT_PORTED = {"mlp": "A16", "rff": "A16"}

__all__ = ["FAMILIES", "NOT_PORTED", "LinearFamily", "PolynomialFamily"]

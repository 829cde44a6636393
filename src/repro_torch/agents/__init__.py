"""Local estimator families — the hypothesis spaces H_i of the paper
(twin of repro.agents): polynomial and its degree-1 case `linear` (closed-
form ridge), rff (closed-form ridge on random Fourier features) and mlp
(warm-started full-batch Adam).

Each family takes `init(key, dtype)` (keys (..., 2) -> params),
`fit(params, x, target)` and `predict(params, x)`, every one batched over
leading agent and trial axes.
"""
from repro_torch.agents.linear import LinearFamily
from repro_torch.agents.mlp import MLPFamily
from repro_torch.agents.polynomial import PolynomialFamily
from repro_torch.agents.rff import RFFFamily

FAMILIES = {"polynomial": PolynomialFamily, "linear": LinearFamily,
            "mlp": MLPFamily, "rff": RFFFamily}

__all__ = ["FAMILIES", "LinearFamily", "MLPFamily", "PolynomialFamily",
           "RFFFamily"]

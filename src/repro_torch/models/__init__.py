"""LM model code (twin of repro.models): the decoder-only assembly for the
dense and ssm families, serving path (prefill and decode)."""
from repro_torch.models.model import Model, build_model

__all__ = ["Model", "build_model"]

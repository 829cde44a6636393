"""LM model code (twin of repro.models): the decoder-only assembly for the
dense, moe, ssm, hybrid and vlm families and the encoder-decoder one for
encdec, training (forward, loss) and serving (prefill and decode)."""
from repro_torch.models.model import Model, build_model, shape_check

__all__ = ["Model", "build_model", "shape_check"]

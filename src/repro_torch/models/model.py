"""Model facade for serving (twin of repro.models.model).

    model = build_model(get_config("smollm-360m"))
    params = model.init(seed=0)                 # on the CUDA card
    logits, cache = model.prefill(params, {"tokens": tokens})
    logits, cache = model.decode_step(params, {"tokens": tok, "idx": i}, cache)

`build_model` takes the families this slice ports, `dense` and `ssm`; the
others, and the ring-buffer decode of `window_cache=True`, raise
NotPortedError naming ROADMAP item A16.  `loss`, `forward`, `input_specs`
and `shape_check` wait for the training slice.  Parameters come from a
torch.Generator (`init`), so they are not the JAX package's draws from the
same seed; repro_torch.convert.lm_params_from_numpy carries the JAX
package's parameters across instead.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.api.runner import resolve_device
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core.icoa import NotPortedError
from repro_torch.models import transformer

__all__ = ["Model", "build_model", "check_ported"]

PORTED_FAMILIES = ("dense", "ssm")


def check_ported(cfg: ModelConfig) -> None:
    """Raise NotPortedError for a configuration this slice does not run."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotPortedError(
            f"{cfg.arch_id}: family {cfg.family!r} waits for ROADMAP A16 (the "
            f"port serves the {' and '.join(PORTED_FAMILIES)} families)")
    if cfg.window_cache:
        raise NotPortedError(
            f"{cfg.arch_id}: window_cache=True (the ring-buffer decode with a "
            f"bidirectional kv_mask) waits for ROADMAP A16")


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    # ------------------------------------------------------------- params
    def init(self, seed: int = 0, device="cuda",
             generator: Optional[torch.Generator] = None) -> dict:
        """Random parameters on `device` (the card unless asked otherwise),
        drawn from `generator` or from a generator seeded with `seed`."""
        if generator is None:
            dev = resolve_device(device, "repro_torch.models.Model.init")
            generator = torch.Generator(device=dev).manual_seed(seed)
        return transformer.init(generator, self.cfg)

    # -------------------------------------------------------------- serve
    def prefill(self, params, batch):
        return transformer.prefill(params, batch, self.cfg)

    def decode_step(self, params, batch, cache):
        return transformer.decode_step(params, batch, cache, self.cfg)

    # -------------------------------------------------------------- cache
    def cache_specs(self, shape: InputShape) -> Any:
        """Per layer, {name: (shape, dtype)} of the decode cache."""
        return transformer.cache_shapes(self.cfg, shape.global_batch, shape.seq_len)

    def make_cache(self, shape: InputShape, device="cuda") -> Any:
        dev = resolve_device(device, "repro_torch.models.Model.make_cache")
        return [{k: torch.zeros(shp, dtype=dt, device=dev) for k, (shp, dt) in layer.items()}
                for layer in self.cache_specs(shape)]


def build_model(cfg: ModelConfig) -> Model:
    check_ported(cfg)
    return Model(cfg)

"""Model facade for training and serving (twin of repro.models.model).

    model = build_model(get_config("smollm-360m"))
    params = model.init(seed=0)                 # on the CUDA card
    loss, metrics = model.loss(params, {"tokens": tokens, "labels": labels})
    logits, cache = model.prefill(params, {"tokens": tokens})
    logits, cache = model.decode_step(params, {"tokens": tok, "idx": i}, cache)

`build_model` takes the families the port runs, `dense`, `ssm`, `moe` and
`hybrid`; the others (`encdec`, `vlm`), and the ring-buffer decode of
`window_cache=True`, raise NotPortedError naming ROADMAP item A16.  `loss`
is the JAX package's: fp32 log-sum-exp over the padded vocabulary, ce + aux,
aux the MoE layers' router losses (0 without MoE layers).  `input_specs`
returns `Spec(shape, dtype)` records (the JAX package's ShapeDtypeStructs),
with int64 token ids, the port's index dtype.  Parameters come from a
torch.Generator (`init`), so they are not the JAX package's draws from the
same seed; repro_torch.convert.lm_params_from_numpy carries the JAX
package's parameters across instead.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.api.runner import resolve_device
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core.icoa import NotPortedError
from repro_torch.models import transformer

__all__ = ["Model", "Spec", "build_model", "check_ported", "shape_check"]


class Spec(NamedTuple):
    """The shape and dtype of one input (jax.ShapeDtypeStruct's role)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


PORTED_FAMILIES = ("dense", "ssm", "moe", "hybrid")


def check_ported(cfg: ModelConfig) -> None:
    """Raise NotPortedError for a configuration this slice does not run."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotPortedError(
            f"{cfg.arch_id}: family {cfg.family!r} waits for ROADMAP A16 (the "
            f"port serves the {', '.join(PORTED_FAMILIES)} families)")
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

    # -------------------------------------------------------------- train
    def forward(self, params, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        return transformer.forward(params, batch, self.cfg)

    def loss(self, params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(mean cross-entropy + aux, {"ce", "aux"}), all fp32."""
        logits, aux = self.forward(params, batch)
        lf = logits.to(torch.float32)
        lse = torch.logsumexp(lf, dim=-1)
        ll = torch.gather(lf, -1, batch["labels"][..., None])[..., 0]
        ce = torch.mean(lse - ll)
        return ce + aux, {"ce": ce, "aux": aux}

    # -------------------------------------------------------------- serve
    def prefill(self, params, batch):
        return transformer.prefill(params, batch, self.cfg)

    def decode_step(self, params, batch, cache):
        return transformer.decode_step(params, batch, cache, self.cfg)

    # -------------------------------------------------------------- specs
    def input_specs(self, shape: InputShape) -> Dict[str, Spec]:
        """The batch of one (arch, input shape) pair: tokens (and labels to
        train) for a full sequence, or one token and its position to decode."""
        b, s = shape.global_batch, shape.seq_len
        if shape.mode in ("train", "prefill"):
            batch = {"tokens": Spec((b, s), torch.int64)}
            if shape.mode == "train":
                batch["labels"] = Spec((b, s), torch.int64)
            return batch
        return {"tokens": Spec((b, 1), torch.int64), "idx": Spec((), torch.int64)}

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


def shape_check(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """Is this (arch, shape) pair applicable? (the JAX package's skips)."""
    if shape.name == "long_500k":
        if cfg.family == "encdec":
            return False, "whisper decoder is a <=448-token speech decoder; 524k KV is meaningless"
        if cfg.family in ("dense", "vlm") and cfg.sliding_window == 0 and cfg.attn_variant != "sliding":
            return False, "full attention at 524k context requires the sliding variant (--attn sliding)"
    return True, ""

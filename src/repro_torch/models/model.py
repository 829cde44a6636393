"""Model facade for training and serving (twin of repro.models.model).

    model = build_model(get_config("smollm-360m"))
    params = model.init(seed=0)                 # on the CUDA card
    loss, metrics = model.loss(params, {"tokens": tokens, "labels": labels})
    logits, cache = model.prefill(params, {"tokens": tokens})
    logits, cache = model.decode_step(params, {"tokens": tok, "idx": i}, cache)

`build_model` takes every family of the configs: the decoder-only ones
(`dense`, `ssm`, `moe`, `hybrid`, `vlm`) run models/transformer.py, `encdec`
models/encdec.py; the ring-buffer decode of `window_cache=True` raises
NotPortedError naming ROADMAP item A16.  `loss` is the JAX package's: fp32
log-sum-exp over the padded vocabulary (for vlm over the text positions
only: the vision prefix carries no LM loss), ce + aux, aux the MoE layers'
router losses (0 without MoE layers).  `input_specs` returns
`Spec(shape, dtype)` records (the JAX package's ShapeDtypeStructs), with
int64 token ids and positions, the port's index dtype, and frames and
vision embeddings in the compute dtype.  Parameters come from a
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
from repro_torch.models import encdec, transformer

__all__ = ["Model", "Spec", "build_model", "check_ported", "shape_check"]


class Spec(NamedTuple):
    """The shape and dtype of one input (jax.ShapeDtypeStruct's role)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


PORTED_FAMILIES = ("dense", "ssm", "moe", "hybrid", "encdec", "vlm")


def check_ported(cfg: ModelConfig) -> None:
    """Raise for a configuration the port does not run: NotPortedError for
    window_cache, ValueError for a family no config has."""
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(f"{cfg.arch_id}: unknown family {cfg.family!r} (the "
                         f"configs' families are {', '.join(PORTED_FAMILIES)})")
    if cfg.window_cache:
        raise NotPortedError(
            f"{cfg.arch_id}: window_cache=True (the ring-buffer decode with a "
            f"bidirectional kv_mask) waits for ROADMAP A16")


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    @property
    def _mod(self):
        """The assembly of this config's family."""
        return encdec if self.cfg.family == "encdec" else transformer

    # ------------------------------------------------------------- params
    def init(self, seed: int = 0, device="cuda",
             generator: Optional[torch.Generator] = None) -> dict:
        """Random parameters on `device` (the card unless asked otherwise),
        drawn from `generator` or from a generator seeded with `seed`."""
        if generator is None:
            dev = resolve_device(device, "repro_torch.models.Model.init")
            generator = torch.Generator(device=dev).manual_seed(seed)
        return self._mod.init(generator, self.cfg)

    # -------------------------------------------------------------- train
    def forward(self, params, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._mod.forward(params, batch, self.cfg)

    def loss(self, params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(mean cross-entropy + aux, {"ce", "aux"}), all fp32."""
        logits, aux = self.forward(params, batch)
        if self.cfg.family == "vlm":                # the vision prefix carries no LM loss
            logits = logits[:, -batch["labels"].shape[1]:]
        lf = logits.to(torch.float32)
        lse = torch.logsumexp(lf, dim=-1)
        ll = torch.gather(lf, -1, batch["labels"][..., None])[..., 0]
        ce = torch.mean(lse - ll)
        return ce + aux, {"ce": ce, "aux": aux}

    # -------------------------------------------------------------- serve
    def prefill(self, params, batch):
        return self._mod.prefill(params, batch, self.cfg)

    def decode_step(self, params, batch, cache):
        return self._mod.decode_step(params, batch, cache, self.cfg)

    # -------------------------------------------------------------- specs
    def input_specs(self, shape: InputShape) -> Dict[str, Spec]:
        """The batch of one (arch, input shape) pair: tokens (and labels to
        train) for a full sequence, with the frames (encdec) or the vision
        embeddings and M-RoPE position ids (vlm, whose text is seq_len less
        the vision tokens), or one token and its position to decode."""
        cfg, i64 = self.cfg, torch.int64
        b, s = shape.global_batch, shape.seq_len
        if shape.mode in ("train", "prefill"):
            n_text = s - cfg.n_vision_tokens if cfg.family == "vlm" else s
            batch = {"tokens": Spec((b, n_text), i64)}
            if cfg.family == "encdec":
                batch["frames"] = Spec((b, cfg.n_frames, cfg.d_model), cfg.cdtype())
            elif cfg.family == "vlm":
                batch["vision_embeds"] = Spec((b, cfg.n_vision_tokens, cfg.d_model),
                                              cfg.cdtype())
                batch["pos_ids"] = Spec((3, b, s), i64)
            if shape.mode == "train":
                batch["labels"] = Spec((b, n_text), i64)
            return batch
        batch = {"tokens": Spec((b, 1), i64), "idx": Spec((), i64)}
        if cfg.family == "vlm":
            batch["pos_ids"] = Spec((3, b, 1), i64)
        return batch

    # -------------------------------------------------------------- cache
    def cache_specs(self, shape: InputShape) -> Any:
        """Per layer, {name: (shape, dtype)} of the decode cache."""
        return self._mod.cache_shapes(self.cfg, shape.global_batch, shape.seq_len)

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

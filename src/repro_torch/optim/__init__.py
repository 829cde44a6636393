"""The optimizer pieces of the training step (twin of repro.optim)."""
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.schedule import cosine_warmup
from repro_torch.optim.clip import global_norm, clip_by_global_norm

__all__ = [
    "AdamWConfig", "adamw_init", "adamw_update",
    "cosine_warmup", "global_norm", "clip_by_global_norm",
]

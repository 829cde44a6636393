"""Architecture config registry: --arch <id> resolution (twin of
repro.configs: the same ten architectures under the same ids)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig, RunConfig

_MODULES = {
    "smollm-360m": "repro_torch.configs.smollm_360m",
    "granite-3-2b": "repro_torch.configs.granite_3_2b",
    "whisper-medium": "repro_torch.configs.whisper_medium",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v01_52b",
    "llama3-405b": "repro_torch.configs.llama3_405b",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1_6b",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi35_moe",
    "qwen2-vl-7b": "repro_torch.configs.qwen2_vl_7b",
    "qwen1.5-4b": "repro_torch.configs.qwen15_4b",
}

ARCH_IDS = list(_MODULES)


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch '{arch_id}'; known: {ARCH_IDS}")
    mod = importlib.import_module(_MODULES[arch_id])
    return mod.smoke_config() if smoke else mod.config()


__all__ = [
    "ARCH_IDS", "get_config", "ModelConfig", "RunConfig", "InputShape", "INPUT_SHAPES",
]

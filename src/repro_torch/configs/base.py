"""Model / run configuration system (twin of repro.configs.base).

Data only: the same fields, defaults and INPUT_SHAPES as the JAX package;
`pdtype()` and `cdtype()` return torch dtypes.

Every assigned architecture gets a `configs/<id>.py` exporting
`config()` (the exact published shape) and `smoke_config()` (a reduced
same-family variant: <=2 layers, d_model <= 512, <= 4 experts) per the
assignment. Input shapes are global; `INPUT_SHAPES` below matches the
assignment table verbatim.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

__all__ = ["ModelConfig", "InputShape", "INPUT_SHAPES", "RunConfig"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int                     # 0 for attention-free (rwkv)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    qkv_bias: bool = False           # qwen1.5
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 2
    moe_every: int = 1               # MoE replaces dense FFN every k-th layer
    capacity_factor: float = 1.25
    moe_group_size: int = 1024       # dispatch group length (bounds dispatch tensors)
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3

    # --- attention variants ---
    sliding_window: int = 0          # 0 = full attention
    attn_variant: str = "full"       # "full" | "sliding" (long-context override)
    attn_impl: str = "eager"         # "eager" | "chunked" (flash-style, §Perf B)
    attn_q_block: int = 512          # q-block length for the chunked impl
    window_cache: bool = False       # ring-buffer decode cache of length
                                     # `window` instead of seq_len (beyond-
                                     # paper; only valid with sliding attn)

    # --- hybrid (jamba) ---
    attn_period: int = 0             # attention layer every k layers (rest mamba)
    # --- mamba ---
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int = 0           # 0 -> ceil(d_model / 16)
    mamba_chunk: int = 0             # 0 = one associative scan over S;
                                     # >0 = chunked scan (§Perf, like rwkv_chunk)
    # --- rwkv ---
    rwkv_head_dim: int = 64
    rwkv_chunk: int = 0              # 0 = sequential scan; >0 = chunked WKV
                                     # (linear-attention form, §Perf hillclimb A)
    seq_shard: bool = False          # Megatron-style sequence-parallel residual
                                     # stream over the model axis (§Perf B)

    # --- enc-dec (whisper) ---
    n_enc_layers: int = 0
    n_frames: int = 1500             # stubbed audio frontend output length

    # --- vlm (qwen2-vl) ---
    n_vision_tokens: int = 0         # stubbed vision frontend output length
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # t/h/w splits of head_dim//2

    # --- numerics / compile strategy ---
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    moment_dtype: str = "float32"    # AdamW moment dtype (bf16 for the giants)
    remat: bool = True
    scan_block: int = 1              # outer-scan block size for 2-level remat
    microbatch: int = 1              # gradient-accumulation microbatches

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def dt_rank(self) -> int:
        return self.mamba_dt_rank or -(-self.d_model // 16)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up so it shards over any axis size up to 256."""
        return -(-self.vocab_size // 2048) * 2048

    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    def layer_kinds(self) -> list[str]:
        """Per-layer mixer kind: 'attn' | 'mamba' | 'rwkv'."""
        if self.family == "ssm":
            return ["rwkv"] * self.n_layers
        if self.family == "hybrid":
            assert self.attn_period > 0
            return [
                "attn" if (i % self.attn_period == self.attn_period // 2) else "mamba"
                for i in range(self.n_layers)
            ]
        return ["attn"] * self.n_layers

    def layer_is_moe(self, i: int) -> bool:
        return self.n_experts > 0 and (i % self.moe_every == self.moe_every - 1)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str                        # "train" | "prefill" | "decode"


# assignment table, verbatim
INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Training-run hyperparameters (launcher-level)."""
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    seed: int = 0

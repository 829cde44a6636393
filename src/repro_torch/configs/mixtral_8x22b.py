"""mixtral-8x22b [moe] — 8 experts top-2, SWA [arXiv:2401.04088]."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="mixtral-8x22b", family="moe",
        n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=16384, vocab_size=32768,
        n_experts=8, top_k=2, moe_every=1,
        sliding_window=4096,
        rope_theta=1e6,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        moment_dtype="bfloat16",
        scan_block=7, microbatch=2,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="mixtral-8x22b-smoke", family="moe",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
        d_ff=512, vocab_size=512,
        n_experts=4, top_k=2, moe_every=1, sliding_window=64, remat=False,
    )

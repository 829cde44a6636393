"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct]."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="phi3.5-moe-42b-a6.6b", family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=6400, vocab_size=32064,
        n_experts=16, top_k=2, moe_every=1,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        moment_dtype="bfloat16",
        scan_block=4, microbatch=1,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="phi3.5-moe-smoke", family="moe",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
        d_ff=448, vocab_size=512,
        n_experts=4, top_k=2, moe_every=1, remat=False,
    )

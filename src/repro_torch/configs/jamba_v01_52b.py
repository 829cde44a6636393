"""jamba-v0.1-52b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2 [arXiv:2403.19887].

Layer pattern: one attention layer per 8 (attn_period=8), MoE FFN every
second layer (moe_every=2), Mamba mixer elsewhere — matching the published
Jamba block structure (4 Jamba blocks of 8 layers).
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="jamba-v0.1-52b", family="hybrid",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab_size=65536,
        n_experts=16, top_k=2, moe_every=2,
        attn_period=8,
        mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        moment_dtype="bfloat16",
        scan_block=2, microbatch=2,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="jamba-v0.1-52b-smoke", family="hybrid",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
        d_ff=512, vocab_size=512,
        n_experts=4, top_k=2, moe_every=2, attn_period=2,
        mamba_d_state=8, remat=False,
    )

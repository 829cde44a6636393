"""llama3-405b [dense] — GQA, 128k vocab [arXiv:2407.21783]."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="llama3-405b", family="dense",
        n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8,
        d_ff=53248, vocab_size=128256, head_dim=128,
        rope_theta=5e5,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        moment_dtype="bfloat16",
        scan_block=14, microbatch=16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="llama3-405b-smoke", family="dense",
        n_layers=2, d_model=512, n_heads=8, n_kv_heads=2,
        d_ff=1664, vocab_size=1024, head_dim=64, remat=False,
    )

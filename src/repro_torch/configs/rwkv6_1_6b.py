"""rwkv6-1.6b [ssm] — Finch, data-dependent decay, attention-free [arXiv:2404.05892]."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="rwkv6-1.6b", family="ssm",
        n_layers=24, d_model=2048, n_heads=0, n_kv_heads=0,
        d_ff=7168, vocab_size=65536,
        rwkv_head_dim=64,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        scan_block=4, microbatch=1,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="rwkv6-1.6b-smoke", family="ssm",
        n_layers=2, d_model=256, n_heads=0, n_kv_heads=0,
        d_ff=896, vocab_size=512, rwkv_head_dim=32, remat=False,
    )

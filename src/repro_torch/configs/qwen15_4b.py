"""qwen1.5-4b [dense] — QKV bias, MHA [hf:Qwen/Qwen1.5-0.5B family]."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="qwen1.5-4b", family="dense",
        n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20,
        d_ff=6912, vocab_size=151936,
        qkv_bias=True,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        scan_block=5, microbatch=1,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="qwen1.5-4b-smoke", family="dense",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
        d_ff=768, vocab_size=512, qkv_bias=True, remat=False,
    )

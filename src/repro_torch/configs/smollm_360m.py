"""smollm-360m [dense] — llama-arch small [hf:HuggingFaceTB/SmolLM-135M family]."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="smollm-360m", family="dense",
        n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
        d_ff=2560, vocab_size=49152,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        scan_block=4, microbatch=1,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="smollm-360m-smoke", family="dense",
        n_layers=2, d_model=240, n_heads=3, n_kv_heads=1,
        d_ff=640, vocab_size=512, remat=False,
    )

"""granite-3-2b [dense] — GQA [hf:ibm-granite/granite-3.0-2b-base]."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="granite-3-2b", family="dense",
        n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8,
        d_ff=8192, vocab_size=49155,  # padded_vocab handles the odd size
        param_dtype="bfloat16", compute_dtype="bfloat16",
        scan_block=5, microbatch=1,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="granite-3-2b-smoke", family="dense",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
        d_ff=1024, vocab_size=515, remat=False,
    )

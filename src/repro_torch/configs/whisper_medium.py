"""whisper-medium [audio] — enc-dec, conv frontend stubbed [arXiv:2212.04356].

The mel-spectrogram + conv feature extractor is a STUB per the assignment
carve-out: input_specs() provides (B, 1500, d_model) frame embeddings. The
24L figure is per stack (24 encoder + 24 decoder, as published).
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="whisper-medium", family="encdec",
        n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=4096, vocab_size=51865, n_frames=1500,
        rope_theta=0.0,  # whisper uses absolute sinusoidal positions, not RoPE
        param_dtype="bfloat16", compute_dtype="bfloat16",
        scan_block=4, microbatch=1,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="whisper-medium-smoke", family="encdec",
        n_layers=2, n_enc_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
        d_ff=1024, vocab_size=640, n_frames=50, rope_theta=0.0, remat=False,
    )

"""qwen2-vl-7b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191].

The ViT vision tower + projector is a STUB per the assignment carve-out:
input_specs() provides (B, n_vision_tokens, d_model) patch embeddings plus the
3-section M-RoPE position ids (temporal / height / width). The language
backbone below consumes them.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="qwen2-vl-7b", family="vlm",
        n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
        d_ff=18944, vocab_size=152064,
        qkv_bias=True, rope_theta=1e6,
        n_vision_tokens=1024,
        mrope_sections=(16, 24, 24),
        param_dtype="bfloat16", compute_dtype="bfloat16",
        scan_block=4, microbatch=2,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="qwen2-vl-smoke", family="vlm",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
        d_ff=768, vocab_size=512, qkv_bias=True,
        n_vision_tokens=16, mrope_sections=(16, 8, 8), remat=False,
    )

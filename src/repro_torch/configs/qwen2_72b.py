"""qwen2-72b [dense]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.

GQA with QKV bias, RoPE, SwiGLU, RMSNorm.  [arXiv:2407.10671; hf]
"""

from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b",
        family="dense",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=29568,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        norm="rmsnorm",
        mlp="swiglu",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        qkv_bias=True,
        norm="rmsnorm",
        mlp="swiglu",
    )

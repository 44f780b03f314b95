"""phi3-mini-3.8b [dense]: 32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064.

RoPE, SwiGLU, full MHA (kv=32), RMSNorm.  [arXiv:2404.14219; unverified]
"""

from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b",
        family="dense",
        num_layers=32,
        d_model=3072,
        num_heads=32,
        num_kv_heads=32,
        head_dim=96,
        d_ff=8192,
        vocab_size=32_064,
        rope_theta=10_000.0,
        norm="rmsnorm",
        mlp="swiglu",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi3-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        norm="rmsnorm",
        mlp="swiglu",
    )

"""minitron-4b [dense]: 32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.

Pruned Nemotron: squared-ReLU MLP, LayerNorm, RoPE.  [arXiv:2407.14679; hf]
"""

from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="minitron-4b",
        family="dense",
        num_layers=32,
        d_model=3072,
        num_heads=24,
        num_kv_heads=8,
        head_dim=128,
        d_ff=9216,
        vocab_size=256_000,
        rope_theta=10_000.0,
        norm="layernorm",
        mlp="relu2",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="minitron-smoke",
        family="dense",
        num_layers=2,
        d_model=48,
        num_heads=3,
        num_kv_heads=1,
        head_dim=16,
        d_ff=144,
        vocab_size=512,
        norm="layernorm",
        mlp="relu2",
    )

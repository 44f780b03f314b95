"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (MQA kv=1) d_ff=7680.

RG-LRU + local attention at 1:2 ratio (pattern rec,rec,attn_local), GeGLU MLP,
window 2048, vocab 256000.  Sub-quadratic: runs long_500k.
[arXiv:2402.19427; hf]
"""

from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        num_layers=26,
        d_model=2560,
        num_heads=10,
        num_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab_size=256_000,
        pattern=("rec", "rec", "attn_local"),
        prefix_kinds=("rec", "rec"),       # 26 = 2 + 8 * 3
        window=2048,
        lru_width=2560,
        conv_width=4,
        rope_theta=10_000.0,
        norm="rmsnorm",
        mlp="geglu",
        subquadratic=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-smoke",
        family="hybrid",
        num_layers=5,
        d_model=64,
        num_heads=2,
        num_kv_heads=1,
        head_dim=32,
        d_ff=128,
        vocab_size=512,
        pattern=("rec", "rec", "attn_local"),
        prefix_kinds=("rec", "rec"),
        window=16,
        lru_width=64,
        conv_width=4,
        norm="rmsnorm",
        mlp="geglu",
        subquadratic=True,
    )

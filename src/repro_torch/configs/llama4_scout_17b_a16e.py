"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1 + 1 shared expert.

iRoPE layout: chunked local attention (8192) on 3 of 4 layers, RoPE-free global
attention every 4th.  Mostly-local -> runs long_500k (see DESIGN.md).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""

from repro_torch.configs.base import ModelConfig, MoEConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202_048,
        pattern=("attn_chunk", "attn_chunk", "attn_chunk", "attn_global"),
        chunk=8192,
        rope_theta=500_000.0,
        norm="rmsnorm",
        mlp="swiglu",
        moe=MoEConfig(
            num_experts=16,
            top_k=1,
            d_ff_expert=8192,
            num_shared=1,
            capacity_factor=1.25,
            router="softmax",
        ),
        subquadratic=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-smoke",
        family="moe",
        num_layers=4,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=96,
        vocab_size=512,
        pattern=("attn_chunk", "attn_chunk", "attn_chunk", "attn_global"),
        chunk=16,
        norm="rmsnorm",
        mlp="swiglu",
        moe=MoEConfig(
            num_experts=4, top_k=1, d_ff_expert=96, num_shared=1,
            capacity_factor=1.5, router="softmax", impl="masked",
        ),
        subquadratic=True,
    )

"""deepseek-v3-671b [moe]: 61L d_model=7168 128H d_ff(expert)=2048 vocab=129280.

MLA (q_lora 1536, kv_lora 512, nope 128, rope 64, v 128); MoE 256 routed
experts top-8 + 1 shared, sigmoid router; first 3 layers dense (d_ff 18432);
multi-token prediction head.  [arXiv:2412.19437; hf]
"""

from repro_torch.configs.base import ModelConfig, MoEConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b",
        family="moe",
        num_layers=61,
        d_model=7168,
        num_heads=128,
        num_kv_heads=128,
        head_dim=128,
        d_ff=18432,              # dense-layer FF (used by prefix layers)
        vocab_size=129_280,
        pattern=("mla",),
        prefix_kinds=("attn_dense_prefix",) * 3,
        dense_d_ff=18432,
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
        rope_theta=10_000.0,
        norm="rmsnorm",
        mlp="swiglu",
        moe=MoEConfig(
            num_experts=256,
            top_k=8,
            d_ff_expert=2048,
            num_shared=1,
            capacity_factor=1.25,
            router="sigmoid",
        ),
        mtp_heads=1,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-smoke",
        family="moe",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=192,
        vocab_size=512,
        pattern=("mla",),
        prefix_kinds=("attn_dense_prefix",),
        dense_d_ff=192,
        q_lora_rank=32,
        kv_lora_rank=16,
        qk_nope_dim=16,
        qk_rope_dim=8,
        v_head_dim=16,
        norm="rmsnorm",
        mlp="swiglu",
        moe=MoEConfig(
            num_experts=4, top_k=2, d_ff_expert=64, num_shared=1,
            capacity_factor=1.5, router="sigmoid", impl="masked",
        ),
        mtp_heads=1,
    )

"""internvl2-26b [vlm]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.

InternViT + InternLM2 backbone; per the assignment the vision frontend is a
STUB -- ``input_specs()`` provides precomputed patch embeddings that are
prepended to the text sequence.  [arXiv:2404.16821; hf]
"""

from repro_torch.configs.base import ModelConfig

NUM_PATCH_EMBEDS = 256  # pixel-shuffled visual tokens per image (stub frontend)


def full_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b",
        family="vlm",
        num_layers=48,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=92_553,
        rope_theta=1_000_000.0,
        norm="rmsnorm",
        mlp="swiglu",
        frontend="patch",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-smoke",
        family="vlm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        norm="rmsnorm",
        mlp="swiglu",
        frontend="patch",
    )

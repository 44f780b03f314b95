"""seamless-m4t-large-v2 [audio]: enc-dec 24L+24L d_model=1024 16H d_ff=8192
vocab=256206.

The audio frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed frame embeddings (seq_len // enc_ratio frames) for the encoder;
the decoder is autoregressive text.  [arXiv:2308.11596; hf]
"""

from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2",
        family="audio",
        num_layers=48,
        enc_layers=24,
        dec_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        head_dim=64,
        d_ff=8192,
        vocab_size=256_206,
        enc_ratio=4,
        rope_theta=10_000.0,
        norm="layernorm",
        mlp="gelu",
        frontend="frame",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="seamless-smoke",
        family="audio",
        num_layers=4,
        enc_layers=2,
        dec_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        enc_ratio=4,
        norm="layernorm",
        mlp="gelu",
        frontend="frame",
    )

"""xlstm-350m [ssm]: 24L d_model=1024 4H vocab=50304; sLSTM + mLSTM blocks.

Pattern: 3 mLSTM blocks then 1 sLSTM block (xLSTM[3:1] flavour).  d_ff=0 --
blocks carry their own inner projections.  Sub-quadratic: runs long_500k.
[arXiv:2405.04517; unverified]
"""

from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m",
        family="ssm",
        num_layers=24,
        d_model=1024,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab_size=50_304,
        pattern=("mlstm", "mlstm", "mlstm", "slstm"),
        norm="rmsnorm",
        mlp="none",
        subquadratic=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-smoke",
        family="ssm",
        num_layers=4,
        d_model=64,
        num_heads=2,
        num_kv_heads=2,
        d_ff=0,
        vocab_size=512,
        pattern=("mlstm", "mlstm", "mlstm", "slstm"),
        norm="rmsnorm",
        mlp="none",
        subquadratic=True,
    )

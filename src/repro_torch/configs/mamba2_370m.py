"""Mamba2-370m — pure SSM (attention-free), SSD state-space duality.
[arXiv:2405.21060; unverified]"""

from repro_torch.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,              # attention-free
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,                   # no MLP blocks; mamba blocks carry the capacity
    vocab_size=50280,
    block_pattern=("mamba",),
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_kernel=4),
    norm="rmsnorm",
    tie_embeddings=True,
    sub_quadratic=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m-smoke",
        family="ssm",
        num_layers=2,
        d_model=64,
        num_heads=0,
        num_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=256,
        block_pattern=("mamba",),
        ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, conv_kernel=4,
                      chunk_size=8),
        norm="rmsnorm",
        tie_embeddings=True,
        sub_quadratic=True,
    )

"""Zamba2-2.7B — hybrid: Mamba2 backbone + shared-weight attention block
applied periodically. [arXiv:2411.15242; hf]"""

from repro_torch.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,              # 2560 / 32
    d_ff=10240,
    vocab_size=32000,
    block_pattern=("mamba",),
    shared_attn_period=6,     # one shared attn+mlp block applied every 6 layers
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_kernel=4),
    mlp_activation="gelu",
    norm="rmsnorm",
    tie_embeddings=True,
    sub_quadratic=True,       # runs long_500k (SSM state is O(1) in context)
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b-smoke",
        family="hybrid",
        num_layers=4,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        block_pattern=("mamba",),
        shared_attn_period=2,
        ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, conv_kernel=4,
                      chunk_size=8),
        mlp_activation="gelu",
        norm="rmsnorm",
        tie_embeddings=True,
        sub_quadratic=True,
    )

"""Qwen3-32B — dense GQA decoder with qk-norm. [hf:Qwen/Qwen3-8B family; hf]"""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    rope_theta=1000000.0,
    qk_norm=True,
    mlp_activation="silu",
    norm="rmsnorm",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=8,
        num_kv_heads=2,
        head_dim=8,
        d_ff=160,
        vocab_size=256,
        qk_norm=True,
        mlp_activation="silu",
        norm="rmsnorm",
    )

"""GLM-4-9B — dense GQA decoder. [hf:THUDM/glm-4-9b; hf]"""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=151552,
    rope_theta=10000.0,
    mlp_activation="silu",
    norm="rmsnorm",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        mlp_activation="silu",
        norm="rmsnorm",
    )

"""StarCoder2-3B — dense GQA decoder, ungated GeLU MLP, LayerNorm.
[arXiv:2402.19173; hf]"""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    rope_theta=999999.4420358813,
    mlp_activation="gelu_mlp",
    norm="layernorm",
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b-smoke",
        family="dense",
        num_layers=2,
        d_model=48,
        num_heads=6,
        num_kv_heads=2,
        head_dim=8,
        d_ff=192,
        vocab_size=256,
        mlp_activation="gelu_mlp",
        norm="layernorm",
        tie_embeddings=True,
    )

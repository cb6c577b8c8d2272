"""Whisper large-v3 — encoder-decoder audio backbone; conv frontend STUBBED
(input_specs provides precomputed frame embeddings). [arXiv:2212.04356]"""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,            # decoder layers
    encoder_layers=32,
    encoder_seq_len=1500,     # 30s of audio after 2x conv subsampling
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,          # MHA
    head_dim=64,              # 1280 / 20
    d_ff=5120,
    vocab_size=51866,
    rope_theta=10000.0,       # the backbone uses RoPE, as the JAX package
    mlp_activation="gelu_mlp",
    norm="layernorm",
    frontend="audio",
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3-smoke",
        family="audio",
        num_layers=2,
        encoder_layers=2,
        encoder_seq_len=16,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        mlp_activation="gelu_mlp",
        norm="layernorm",
        frontend="audio",
        tie_embeddings=True,
    )

"""Qwen2-VL-2B — VLM text backbone with M-RoPE; vision patch frontend STUBBED
(input_specs provides patch embeddings / 3D rope position ids).
[arXiv:2409.12191; hf]"""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    rope_theta=1000000.0,
    rope_sections=(16, 24, 24),   # M-RoPE temporal/height/width sections
    mlp_activation="silu",
    norm="rmsnorm",
    tie_embeddings=True,
    frontend="vision",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b-smoke",
        family="vlm",
        num_layers=2,
        d_model=48,
        num_heads=4,
        num_kv_heads=2,
        head_dim=12,
        d_ff=96,
        vocab_size=256,
        rope_sections=(2, 2, 2),
        mlp_activation="silu",
        norm="rmsnorm",
        tie_embeddings=True,
        frontend="vision",
    )

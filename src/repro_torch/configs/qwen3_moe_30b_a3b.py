"""Qwen3-30B-A3B — MoE, 128 experts top-8, per-expert d_ff=768, qk-norm.
[hf:Qwen/Qwen3-30B-A3B; hf]"""

from repro_torch.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,                  # per-expert intermediate size
    vocab_size=151936,
    rope_theta=1000000.0,
    qk_norm=True,
    moe=MoEConfig(num_experts=128, experts_per_token=8, d_ff_expert=768),
    mlp_activation="silu",
    norm="rmsnorm",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=32,
        vocab_size=256,
        qk_norm=True,
        moe=MoEConfig(num_experts=8, experts_per_token=2, d_ff_expert=32),
        mlp_activation="silu",
        norm="rmsnorm",
    )

"""Grok-1 314B — MoE, 8 experts top-2, the largest assigned model. One
H100 holds 4 of its 64 layers in bf16.
[hf:xai-org/grok-1; unverified]"""

from repro_torch.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32768,                # per-expert intermediate size
    vocab_size=131072,
    rope_theta=10000.0,
    attn_logit_softcap=30.0,   # grok-1 tanh attn-logit cap
    final_logit_softcap=30.0,
    moe=MoEConfig(num_experts=8, experts_per_token=2, d_ff_expert=32768),
    mlp_activation="gelu",
    norm="rmsnorm",
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=64,
        vocab_size=256,
        attn_logit_softcap=30.0,
        final_logit_softcap=30.0,
        moe=MoEConfig(num_experts=4, experts_per_token=2, d_ff_expert=64),
        mlp_activation="gelu",
        norm="rmsnorm",
        tie_embeddings=True,
    )

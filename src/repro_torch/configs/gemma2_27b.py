"""Gemma 2 27B — local/global alternating attention, logit softcaps.
[arXiv:2408.00118; hf]"""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    rope_theta=10000.0,
    block_pattern=("local", "attn"),
    sliding_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    attn_scale=(4608 // 32) ** -0.5,  # query_pre_attn_scalar = d_model/num_heads
    mlp_activation="gelu",            # GeGLU
    norm="rmsnorm",
    post_block_norm=True,
    tie_embeddings=True,
    embedding_scale=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b-smoke",
        family="dense",
        num_layers=4,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=256,
        vocab_size=256,
        block_pattern=("local", "attn"),
        sliding_window=16,
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        attn_scale=(64 // 4) ** -0.5,
        mlp_activation="gelu",
        norm="rmsnorm",
        post_block_norm=True,
        tie_embeddings=True,
        embedding_scale=True,
    )

"""Model configuration for the PyTorch port.

The same frozen dataclass as the JAX package's ``ModelConfig``, field for
field, so a config resolves to equal values in both packages (the port's
tests compare them). Only the fields' *values* matter to the port; the
family-specific sub-configs (``moe``, ``ssm``) stay untyped until a slice
that serves those families brings their dataclasses over.

Every ported architecture lives in ``repro_torch.configs.<id>`` exposing
``CONFIG`` (full size) and ``smoke_config()`` (reduced, runs on the CPU).
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass

# Layer kinds used by block patterns.
ATTN = "attn"            # full global attention block
LOCAL_ATTN = "local"     # sliding-window attention block
MAMBA = "mamba"          # Mamba2 (SSD) block


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    experts_per_token: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int            # N (ssm_state)
    head_dim: int = 64        # P
    expand: int = 2           # d_inner = expand * d_model
    conv_kernel: int = 4
    chunk_size: int = 256
    n_groups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # --- attention options -------------------------------------------------
    rope_theta: float = 10000.0
    rope_sections: tuple[int, ...] | None = None   # M-RoPE (qwen2-vl): (t,h,w)
    qk_norm: bool = False                           # qwen3 family
    attn_logit_softcap: float | None = None         # gemma2 (50.0), grok
    final_logit_softcap: float | None = None        # gemma2 (30.0)
    sliding_window: int | None = None               # local-attn window size
    attn_scale: float | None = None                 # override 1/sqrt(head_dim)
    # --- block structure ----------------------------------------------------
    block_pattern: tuple[str, ...] = (ATTN,)
    shared_attn_period: int = 0
    # --- MLP ------------------------------------------------------------------
    mlp_activation: str = "silu"     # silu (SwiGLU) | gelu (GeGLU) | gelu_mlp
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    post_block_norm: bool = False
    tie_embeddings: bool = False
    embedding_scale: bool = False
    # --- mixture / ssm -----------------------------------------------------
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    # --- encoder-decoder ----------------------------------------------------
    encoder_layers: int = 0
    encoder_seq_len: int = 0
    # --- modality frontend stub ----------------------------------------------
    frontend: str | None = None
    # --- numerics -------------------------------------------------------------
    dtype: str = "bfloat16"
    sub_quadratic: bool = False

    @property
    def padded_vocab_size(self) -> int:
        """Vocab padded to a multiple of 256 (the JAX package shards the
        table over its mesh "model" axis); padded logit columns are masked."""
        return -(-self.vocab_size // 256) * 256

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def layer_kinds(self) -> tuple[str, ...]:
        """Expanded per-layer kind list of length num_layers."""
        pat = self.block_pattern
        reps = -(-self.num_layers // len(pat))
        return (pat * reps)[: self.num_layers]

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head), counted
        as the JAX package counts."""
        d = self.d_model
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        mlp = self._mlp_params()
        for kind in self.layer_kinds():
            if kind in (ATTN, LOCAL_ATTN):
                n += attn + mlp + 2 * d
            elif kind == MAMBA:
                n += self._mamba_params() + d
        if self.shared_attn_period:
            n += attn + mlp + 2 * d
        if self.encoder_layers:
            # encoder self-attention + MLP blocks, and each decoder
            # layer's cross attention
            n += self.encoder_layers * (attn + mlp + 2 * d)
            n += self.num_layers * (attn + d)
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only the routed experts)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        inactive = (m.num_experts - m.experts_per_token) * (
            3 * self.d_model * m.d_ff_expert)
        return self.param_count() - self.num_layers * inactive

    def _mlp_params(self) -> int:
        if self.moe is not None:
            m = self.moe
            return self.d_model * m.num_experts + (
                m.num_experts * 3 * self.d_model * m.d_ff_expert)
        mats = 2 if self.mlp_activation == "gelu_mlp" else 3
        return mats * self.d_model * self.d_ff

    def _mamba_params(self) -> int:
        s = self.ssm
        d, di = self.d_model, s.d_inner(self.d_model)
        nh, N = s.n_heads(self.d_model), s.state_dim
        in_proj = d * (2 * di + 2 * s.n_groups * N + nh)
        conv = s.conv_kernel * (di + 2 * s.n_groups * N)
        return in_proj + conv + nh + nh + di * d + di  # A, D, out_proj, norm


# ---------------------------------------------------------------------------
# Shapes, parallelism and the optimizer (the training slice)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                # train | prefill | decode


@dataclass(frozen=True)
class ParallelConfig:
    """The JAX package's parallel configuration, field for field. On a
    mesh the trainer shards the masters and slots over "data" with
    ``zero1`` (on one device it shards nothing). The serving engine reads
    ``expert_ff_2d`` (``InferenceEngine(pcfg=...)``: grok-1's MoE layout,
    the expert d_ff over ("data", "model")). What training still lacks,
    refused by name (``spmd.steps.check_train_config``; ROADMAP.md queue
    1 item 12): ``fsdp``, ``seq_shard_activations``, and tensor
    parallelism of the MoE, SSM, hybrid, encoder-decoder and VLM
    families (they train data parallel)."""
    fsdp: bool = False            # shard params over "data" too
    zero1: bool = True            # shard optimizer state over "data"
    remat: str = "full"           # none | dots | full
    microbatches: int = 1         # gradient accumulation
    seq_shard_activations: bool = False  # sequence-parallel saved activations
    expert_ff_2d: bool = False    # serving: shard expert d_ff over (data,model)


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    schedule: str = "cosine"       # constant | cosine | linear
    total_steps: int = 10_000
    compression: str = "none"      # none | int8_ef (never read by the
                                   # JAX trainer; refused by the port's)
    slot_dtype: str = "float32"    # "bfloat16" halves moment memory
                                   # (masters stay fp32; math in fp32)


ARCHS: tuple[str, ...] = (
    "glm4_9b",
    "starcoder2_3b",
    "gemma2_27b",
    "qwen3_32b",
    "whisper_large_v3",
    "zamba2_2p7b",
    "qwen2_vl_2b",
    "qwen3_moe_30b_a3b",
    "grok1_314b",
    "mamba2_370m",
)

# Accept dashed ids from the assignment table as aliases.
_ALIASES = {
    "glm4-9b": "glm4_9b",
    "starcoder2-3b": "starcoder2_3b",
    "gemma2-27b": "gemma2_27b",
    "qwen3-32b": "qwen3_32b",
    "whisper-large-v3": "whisper_large_v3",
    "zamba2-2.7b": "zamba2_2p7b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "grok-1-314b": "grok1_314b",
    "mamba2-370m": "mamba2_370m",
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    """Resolve an architecture id to its full-size or smoke config."""
    arch = _ALIASES.get(arch, arch)
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}; known: {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.smoke_config() if smoke else mod.CONFIG

"""Norms, rotary embeddings and MLP blocks (port of ``repro.models.layers``).

Same op order as the JAX package: norms in fp32 and cast back, rope tables
in fp32 cast to the activation dtype before the rotate-half products, MLP
weights cast to the activation dtype before the products.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.spmd import collectives


def apply_norm(params, x, cfg: ModelConfig, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    if cfg.norm == "layernorm":
        mu = x.mean(dim=-1, keepdim=True)
        var = (x - mu).square().mean(dim=-1, keepdim=True)
        y = (x - mu) * torch.rsqrt(var + eps)
        y = y * params["scale"].float() + params["bias"].float()
    else:
        var = x.square().mean(dim=-1, keepdim=True)
        y = x * torch.rsqrt(var + eps) * params["scale"].float()
    return y.to(dt)


def rms_norm_fp32(x, scale, eps: float = 1e-6):
    """Bare RMS-norm over the last axis in fp32, cast back (qk-norm)."""
    dt = x.dtype
    x = x.float()
    y = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_cos_sin(positions, head_dim: int, theta: float,
                 sections: tuple[int, ...] | None = None):
    """cos/sin tables (B, S, hd/2) fp32. positions: (B, S) integers, or
    (3, B, S) for M-RoPE (qwen2-vl), whose planes are the temporal,
    height and width position ids: the hd/2 frequency slots are split into
    ``sections`` groups (sizes in half-dim units), group i indexed by
    plane i. (B, S) positions take the 1-D tables whatever ``sections``."""
    inv = rope_freqs(head_dim, theta, positions.device)
    ang = positions[..., None].float() * inv          # (B,S | 3,B,S, hd/2)
    if positions.dim() == 3:
        if sections is None or sum(sections) != head_dim // 2:
            raise ValueError(f"M-RoPE: sections {sections} must sum to "
                             f"head_dim / 2 = {head_dim // 2}")
        parts, start = [], 0
        for i, sec in enumerate(sections):
            parts.append(ang[i, :, :, start:start + sec])
            start += sec
        ang = torch.cat(parts, dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, S, H, hd); cos/sin: (B, S, hd/2). Rotate-half convention."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


_ACT = {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh")}


def apply_mlp(params, x, cfg: ModelConfig):
    """The MLP. Where the weights hold a sharding "model" group's ``ff``
    slice (Megatron-style: ``w_gate`` / ``w_in`` column parallel,
    ``w_out`` row parallel; in training, or serving with sharded
    weights), x enters through ``collectives.copy_to`` and the partial
    outputs are summed over the group."""
    grp = collectives.shard_group(params["w_in"].shape[-1], cfg.d_ff,
                                  "the MLP's ff slice")
    x = collectives.copy_to(x, grp)
    w = {k: v.to(x.dtype) for k, v in params.items()}
    if cfg.mlp_activation == "gelu_mlp":
        y = _ACT["gelu"](x @ w["w_in"]) @ w["w_out"]
    else:
        g = _ACT[cfg.mlp_activation](x @ w["w_gate"])
        y = (g * (x @ w["w_in"])) @ w["w_out"]
    return collectives.reduce_from(y, grp)


def softcap(x, cap: float | None):
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)

"""Token embedding and logits (port of the serving half of
``repro.models.embedding``). Single device: the JAX package's vocab-sharded
Part/Gather/Stitch collapses to one clamped gather, and its vocab-parallel
logits to one fp32 product."""

from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import softcap

NEG = -1.0e30


def head_table(params, cfg: ModelConfig):
    return params["table"] if cfg.tie_embeddings else params["head"]


def embed(table, tokens, cfg: ModelConfig):
    """tokens: (B, S) int -> (B, S, d) in the activation dtype. As in the
    JAX package, ids are clamped into [0, V_pad) for the gather and rows of
    out-of-range ids come out zero."""
    V = table.shape[0]
    ids = tokens.clamp(0, V - 1).to(torch.int32)
    ok = (tokens >= 0) & (tokens < V)
    out = torch.where(ok[..., None], ops.embedding_gather(table, ids), 0)
    return out.to(torch.bfloat16 if cfg.dtype == "bfloat16"
                  else torch.float32)


def decode_logits(x, table, cfg: ModelConfig):
    """x: (B, 1, d) -> (B, V_pad) fp32 logits, vocab-padding columns set to
    NEG. A true fp32 product: pass an fp32 ``table`` to skip the per-call
    cast (the serving runner keeps one fp32 copy of the head)."""
    logits = x[:, 0].float() @ table.float().T
    logits = softcap(logits, cfg.final_logit_softcap)
    col_ok = torch.arange(table.shape[0], device=x.device) < cfg.vocab_size
    return torch.where(col_ok[None, :], logits, NEG)


def decode_logits_argmax(x, table, cfg: ModelConfig):
    """Greedy next token. x: (B, 1, d) -> (B,) int32."""
    return decode_logits(x, table, cfg).argmax(dim=-1).to(torch.int32)

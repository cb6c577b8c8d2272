"""Dense decoder serving forward (port of the paged serving pair of
``repro.models.transformer``): ``decode_step_paged`` and
``prefill_chunk_paged``.

A Python loop over layers replaces ``lax.scan``. Parameters are a dict:
``{"embed": {"table", "head"}, "layers": [per-layer dict, ...],
"final_norm": {"scale"}}``, where each per-layer dict is one slice of the
JAX package's stacked ``blocks/sub0`` tree (``norm``, ``attn/{wq,wk,wv,
wo}``, ``norm2``, ``mlp/{w_gate,w_in,w_out}``). The KV cache is
``{"k", "v"}`` page pools shaped ``(num_layers, num_blocks, block_size, K,
hd)``; both steps write their new KV rows into it in place (the JAX
package donates the pools instead) and return it.
"""

from __future__ import annotations

import torch

from repro_torch.config import LOCAL_ATTN, ModelConfig
from repro_torch.models.attention import (attention_scale, out_proj,
                                          paged_chunk_attention,
                                          paged_decode_attention, project_kv,
                                          project_q, update_paged_cache,
                                          update_paged_cache_chunk)
from repro_torch.models.embedding import decode_logits, embed, head_table
from repro_torch.models.layers import apply_mlp, apply_norm, rope_cos_sin


def _mlp_part(lp, x, cfg: ModelConfig):
    return x + apply_mlp(lp["mlp"], apply_norm(lp["norm2"], x, cfg), cfg)


def _layers(params, cache, cfg: ModelConfig, x, attend):
    """Run every layer: ``attend(lp, h, k_pool, v_pool, window)`` returns the
    attention output for normed input ``h`` after writing its KV."""
    for i, (lp, kind) in enumerate(zip(params["layers"], cfg.layer_kinds())):
        window = cfg.sliding_window if kind == LOCAL_ATTN else None
        h = apply_norm(lp["norm"], x, cfg)
        y = attend(lp["attn"], h, cache["k"][i], cache["v"][i], window)
        x = x + out_proj(lp["attn"], y, x.dtype)
        x = _mlp_part(lp, x, cfg)
    return apply_norm(params["final_norm"], x, cfg)


def decode_step_paged(params, cache, batch, cfg: ModelConfig, head=None):
    """One decode token against the paged KV cache (all serving slots).

    batch: token (B, 1), pos (B,) write position, block_tables (B, nb),
    ctx_lens (B,) visible tokens incl. this one (0 masks an idle slot).
    ``head`` overrides the logits table (an fp32 copy, see
    ``decode_logits``). Returns (logits (B, V_pad) fp32, cache).
    """
    pos = batch["pos"]
    x = embed(params["embed"]["table"], batch["token"], cfg)
    cos_sin = rope_cos_sin(pos[:, None], cfg.head_dim, cfg.rope_theta)
    bt, ctx_lens = batch["block_tables"], batch["ctx_lens"]

    def attend(ap, h, kp, vp, window):
        q = project_q(ap, h, cfg, cos_sin)
        k, v = project_kv(ap, h, cfg, cos_sin)
        update_paged_cache(kp, k, bt, pos)
        update_paged_cache(vp, v, bt, pos)
        return paged_decode_attention(q, kp, vp, bt, ctx_lens, window=window,
                                      cap=cfg.attn_logit_softcap,
                                      scale=attention_scale(cfg))

    x = _layers(params, cache, cfg, x, attend)
    head = head_table(params["embed"], cfg) if head is None else head
    return decode_logits(x, head, cfg), cache


def prefill_chunk_paged(params, cache, batch, cfg: ModelConfig, head=None):
    """One chunk of prompt prefill against the paged KV cache.

    batch: tokens (B, C) the chunk's token slice (right-padded), q_start
    (B,) absolute position of column 0, q_lens (B,) valid columns,
    block_tables (B, nb), ctx_lens (B,) = q_start + q_lens.
    Returns (logits (B, V_pad) fp32 at each row's last valid token, cache).
    """
    tokens = batch["tokens"]
    B, C = tokens.shape
    x = embed(params["embed"]["table"], tokens, cfg)
    q_start, q_lens = batch["q_start"], batch["q_lens"]
    positions = q_start[:, None] + torch.arange(C, dtype=q_start.dtype,
                                                device=tokens.device)
    cos_sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    bt, ctx_lens = batch["block_tables"], batch["ctx_lens"]

    def attend(ap, h, kp, vp, window):
        q = project_q(ap, h, cfg, cos_sin)
        k, v = project_kv(ap, h, cfg, cos_sin)
        update_paged_cache_chunk(kp, k, bt, q_start, q_lens)
        update_paged_cache_chunk(vp, v, bt, q_start, q_lens)
        return paged_chunk_attention(q, kp, vp, bt, ctx_lens, q_lens,
                                     window=window,
                                     cap=cfg.attn_logit_softcap,
                                     scale=attention_scale(cfg))

    x = _layers(params, cache, cfg, x, attend)
    last = (q_lens.long() - 1).clamp(0, C - 1)
    x_last = x[torch.arange(B, device=x.device), last][:, None]   # (B,1,d)
    head = head_table(params["embed"], cfg) if head is None else head
    return decode_logits(x_last, head, cfg), cache

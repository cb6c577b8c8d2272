"""Dense decoder serving forward (port of the paged serving trio of
``repro.models.transformer``): ``decode_step_paged``,
``prefill_chunk_paged`` and ``prefill_chunk_ragged``.

A Python loop over layers replaces ``lax.scan``. Parameters are a dict:
``{"embed": {"table", "head"}, "layers": [per-layer dict, ...],
"final_norm": {"scale"}}``, where each per-layer dict is one slice of the
JAX package's stacked ``blocks/sub0`` tree (``norm``, ``attn/{wq,wk,wv,
wo}``, ``norm2``, ``mlp/{w_gate,w_in,w_out}``). The KV cache is
``{"k", "v"}`` page pools shaped ``(num_layers, num_blocks, block_size, K,
hd)``, plus fp32 ``{"k_scale", "v_scale"}`` pools ``(..., K, 1)`` when the
pools are int8 / fp8. Every step writes its new KV rows into it in place
(the JAX package donates the pools instead) and returns it; into a
quantized pool the rows are quantized first, their scale rows scattered
beside them, and the attention dequantizes.
"""

from __future__ import annotations

import torch

from repro_torch.config import LOCAL_ATTN, ModelConfig
from repro_torch.models import quant
from repro_torch.models.attention import (attention_scale, out_proj,
                                          paged_chunk_attention,
                                          paged_decode_attention, project_kv,
                                          project_q,
                                          ragged_chunk_update_attend,
                                          update_paged_cache,
                                          update_paged_cache_chunk)
from repro_torch.models.embedding import decode_logits, embed, head_table
from repro_torch.models.layers import apply_mlp, apply_norm, rope_cos_sin


def _mlp_part(lp, x, cfg: ModelConfig):
    return x + apply_mlp(lp["mlp"], apply_norm(lp["norm2"], x, cfg), cfg)


def _layers(params, cache, cfg: ModelConfig, x, attend):
    """Run every layer: ``attend(lp, h, pools, window)`` returns the
    attention output for normed input ``h`` after writing its KV into
    ``pools``, the layer's slice of every cache pool."""
    for i, (lp, kind) in enumerate(zip(params["layers"], cfg.layer_kinds())):
        window = cfg.sliding_window if kind == LOCAL_ATTN else None
        h = apply_norm(lp["norm"], x, cfg)
        y = attend(lp["attn"], h, {n: p[i] for n, p in cache.items()},
                   window)
        x = x + out_proj(lp["attn"], y, x.dtype)
        x = _mlp_part(lp, x, cfg)
    return apply_norm(params["final_norm"], x, cfg)


def _store_kv(pools, k, v, update, *args):
    """Write new K/V rows into a layer's pools with ``update(pool, rows,
    *args)``: quantized first for an int8/fp8 pool, whose scale rows go
    into the scale pools. Returns the attention's scale keywords."""
    scales = {}
    if "k_scale" in pools:
        kvd = quant.kv_dtype_name(pools["k"].dtype)
        k, ksr = quant.quantize_kv(k, kvd)
        v, vsr = quant.quantize_kv(v, kvd)
        update(pools["k_scale"], ksr, *args)
        update(pools["v_scale"], vsr, *args)
        scales = {"k_scale": pools["k_scale"], "v_scale": pools["v_scale"]}
    update(pools["k"], k, *args)
    update(pools["v"], v, *args)
    return scales


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

    def attend(ap, h, pools, window):
        q = project_q(ap, h, cfg, cos_sin)
        k, v = project_kv(ap, h, cfg, cos_sin)
        scales = _store_kv(pools, k, v, update_paged_cache, bt, pos)
        return paged_decode_attention(q, pools["k"], pools["v"], bt,
                                      ctx_lens, window=window,
                                      cap=cfg.attn_logit_softcap,
                                      scale=attention_scale(cfg), **scales)

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

    def attend(ap, h, pools, window):
        q = project_q(ap, h, cfg, cos_sin)
        k, v = project_kv(ap, h, cfg, cos_sin)
        scales = _store_kv(pools, k, v, update_paged_cache_chunk, bt,
                           q_start, q_lens)
        return paged_chunk_attention(q, pools["k"], pools["v"], bt, ctx_lens,
                                     q_lens, window=window,
                                     cap=cfg.attn_logit_softcap,
                                     scale=attention_scale(cfg), **scales)

    x = _layers(params, cache, cfg, x, attend)
    last = (q_lens.long() - 1).clamp(0, C - 1)
    x_last = x[torch.arange(B, device=x.device), last][:, None]   # (B,1,d)
    head = head_table(params["embed"], cfg) if head is None else head
    return decode_logits(x_last, head, cfg), cache


def prefill_chunk_ragged(params, cache, batch, cfg: ModelConfig, head=None):
    """Packed (ragged) prompt prefill: the chunks of up to S sequences ride
    one flat token row against the paged KV cache.

    batch: tokens (1, T) chunks packed back to back (right-padded),
    positions (1, T) each row's absolute position, starts/ends (S,) flat
    row ranges per packed sequence (start == end marks an unused pack
    slot), row_seq (T,) each row's owning pack slot, block_tables (S, nb),
    ctx_lens (S,) visible tokens including each chunk. Row-wise work
    (embedding, norms, projections, MLP) runs once over the flat row; the
    KV store and the attention are one fused op per layer.
    Returns (logits (S, V_pad) fp32 at each sequence's last row, cache).
    """
    tokens = batch["tokens"]
    T = tokens.shape[1]
    x = embed(params["embed"]["table"], tokens, cfg)
    cos_sin = rope_cos_sin(batch["positions"], cfg.head_dim, cfg.rope_theta)
    seqs = (batch["block_tables"], batch["ctx_lens"], batch["starts"],
            batch["ends"], batch["row_seq"])

    def attend(ap, h, pools, window):
        q = project_q(ap, h, cfg, cos_sin)
        k, v = project_kv(ap, h, cfg, cos_sin)
        scales = {n: pools[n] for n in ("k_scale", "v_scale") if n in pools}
        return ragged_chunk_update_attend(
            q, k, v, pools["k"], pools["v"], *seqs, window=window,
            cap=cfg.attn_logit_softcap, scale=attention_scale(cfg),
            **scales)[0]

    x = _layers(params, cache, cfg, x, attend)
    last = (batch["ends"].long() - 1).clamp(0, T - 1)             # (S,)
    head = head_table(params["embed"], cfg) if head is None else head
    return decode_logits(x[0, last][:, None], head, cfg), cache

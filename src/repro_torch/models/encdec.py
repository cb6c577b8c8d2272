"""Whisper-style encoder-decoder backbone (port of ``repro.models.encdec``).

The conv audio frontend is a stub, as in the JAX package: a request
carries precomputed frame embeddings (T_enc, d_model). The backbone is
the JAX package's: a bidirectional encoder (RoPE at positions 0 .. T_enc -
1, non-causal attention), then decoder layers of causal self-attention,
cross attention to the encoder output (no RoPE on either side) and an
MLP. Parameters: ``{"embed", "encoder": [layer, ...], "decoder":
[layer, ...], "enc_final_norm", "final_norm"}``; an encoder layer holds
``norm``, ``attn``, ``norm2``, ``mlp``, a decoder layer also ``xnorm`` and
``xattn`` between its self attention and its MLP.

Entry points: the training loss ``forward_loss`` (each encoder and
decoder layer body under remat), ``encode`` and ``encode_cross_kv`` (the serving engine's
admission pass: every decoder layer's cross K/V of one request), the
static path ``prefill`` / ``decode_step`` over dense caches ``{"k", "v"}
(L, B, max_len, K, hd)`` and ``{"xk", "xv"} (L, B, T_enc, K, hd)``, and
the engine's ``prefill_chunk_paged`` / ``decode_step_paged`` over the
self-attention page pools ``cache["self"]`` and the per-slot cross K/V
``cache["cross"]``, which no step writes. Full-sequence attention (the
encoder, the static prefill, a chunk's cross attention against all
T_enc keys) goes through ``sharded_attention`` (the flash kernel on the
card, its hd-64 route for whisper); the decode's cross attention is
``decode_attention_local`` against all T_enc keys, as in the reference.
With tensor parallelism the engine paths write and attend this rank's kv
heads of the pools and of the cross K/V, and gather the heads
(``models.attention``).
"""

from __future__ import annotations

import functools

import torch

from repro_torch.config import ModelConfig
from repro_torch.models.attention import (attention_scale, decode_attention,
                                          decode_attention_local,
                                          local_kv_heads, out_proj,
                                          over_local_heads,
                                          paged_chunk_attention,
                                          paged_decode_attention, project_kv,
                                          project_q, sharded_attention,
                                          update_cache, update_paged_cache,
                                          update_paged_cache_chunk)
from repro_torch.models.embedding import (decode_logits, embed, head_table,
                                          lm_loss)
from repro_torch.models.layers import apply_mlp, apply_norm, rope_cos_sin
from repro_torch.models.remat import MODES, remat


def _arange_positions(B: int, S: int, device):
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(
        B, S)


def _rope(cfg: ModelConfig, positions):
    return rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)


def _mlp(lp, x, cfg: ModelConfig):
    return x + apply_mlp(lp["mlp"], apply_norm(lp["norm2"], x, cfg), cfg)


def _enc_layer(lp, cfg: ModelConfig, cos_sin, x):
    """One bidirectional encoder layer."""
    h = apply_norm(lp["norm"], x, cfg)
    q = project_q(lp["attn"], h, cfg, cos_sin)
    k, v = project_kv(lp["attn"], h, cfg, cos_sin)
    y = sharded_attention(q, k, v, cfg, causal=False,
                          scale=attention_scale(cfg))
    x = x + out_proj(lp["attn"], y, x.dtype)
    return _mlp(lp, x, cfg)


def _layer_remat(mode: str) -> str:
    """The JAX package checkpoints the encoder's and the decoder's layer
    bodies with no policy under any remat mode but "none"."""
    if mode not in MODES:
        raise ValueError(f"remat={mode!r}: one of {MODES}")
    return "none" if mode == "none" else "full"


def encode(params, frames, cfg: ModelConfig, remat_mode: str = "none"):
    """frames (B, T_enc, d_model) in the activation dtype -> the encoder
    output (B, T_enc, d_model): bidirectional self-attention layers and
    the final norm. ``remat_mode`` (training): each layer body under
    ``models.remat``, as ``_layer_remat`` maps it."""
    B, Te, _ = frames.shape
    cos_sin = _rope(cfg, _arange_positions(B, Te, frames.device))
    mode = _layer_remat(remat_mode)
    x = frames
    for lp in params["encoder"]:
        x = remat(functools.partial(_enc_layer, lp, cfg, cos_sin), mode)(x)
    return apply_norm(params["enc_final_norm"], x, cfg)


def encode_cross_kv(params, frames, cfg: ModelConfig):
    """Run the encoder once and project every decoder layer's cross K/V.
    frames (B, T_enc, d_model). Returns {"xk", "xv"} each (L, B, T_enc,
    K, hd): the serving encoder cache's rows, written once per request at
    admission."""
    enc_out = encode(params, frames, cfg)
    kv = [project_kv(lp["xattn"], enc_out, cfg, None)
          for lp in params["decoder"]]
    return {"xk": torch.stack([k for k, _ in kv]),
            "xv": torch.stack([v for _, v in kv])}


def _decoder(params, x, cfg: ModelConfig, self_attend, cross_attend):
    """The decoder layers in order. ``self_attend(ap, h, l)`` returns layer
    l's self-attention output for normed input h (after writing its KV),
    ``cross_attend(ap, h, l)`` its cross attention's. Returns the final
    normed stream."""
    for layer, lp in enumerate(params["decoder"]):
        h = apply_norm(lp["norm"], x, cfg)
        x = x + out_proj(lp["attn"], self_attend(lp["attn"], h, layer),
                         x.dtype)
        h = apply_norm(lp["xnorm"], x, cfg)
        x = x + out_proj(lp["xattn"], cross_attend(lp["xattn"], h, layer),
                         x.dtype)
        x = _mlp(lp, x, cfg)
    return apply_norm(params["final_norm"], x, cfg)


def _dec_layer(lp, cfg: ModelConfig, cos_sin, x, enc_out):
    """One decoder layer over the whole sequence (training): causal self
    attention, cross attention to the encoder output, the MLP."""
    scale = attention_scale(cfg)
    h = apply_norm(lp["norm"], x, cfg)
    q = project_q(lp["attn"], h, cfg, cos_sin)
    k, v = project_kv(lp["attn"], h, cfg, cos_sin)
    y = sharded_attention(q, k, v, cfg, causal=True, scale=scale)
    x = x + out_proj(lp["attn"], y, x.dtype)
    h = apply_norm(lp["xnorm"], x, cfg)
    qx = project_q(lp["xattn"], h, cfg, None)
    kx, vx = project_kv(lp["xattn"], enc_out, cfg, None)
    yx = sharded_attention(qx, kx, vx, cfg, causal=False, scale=scale)
    x = x + out_proj(lp["xattn"], yx, x.dtype)
    return _mlp(lp, x, cfg)


def forward_loss(params, batch, cfg: ModelConfig, pcfg):
    """Training loss: batch frames (B, T_enc, d) (bf16, the frontend
    stub's embeddings), tokens (B, S), labels (B, S). The encoder, then
    the decoder with cross attention, then the LM loss; each encoder and
    decoder layer body under ``pcfg.remat`` (``_layer_remat``). Returns
    (ce, {"ce", "aux" = 0})."""
    mode = _layer_remat(pcfg.remat)
    enc_out = encode(params, batch["frames"], cfg, pcfg.remat)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed(params["embed"]["table"], tokens, cfg)
    cos_sin = _rope(cfg, _arange_positions(B, S, tokens.device))
    for lp in params["decoder"]:
        x = remat(functools.partial(_dec_layer, lp, cfg, cos_sin), mode)(
            x, enc_out)
    x = apply_norm(params["final_norm"], x, cfg)
    ce = lm_loss(x, head_table(params["embed"], cfg), batch["labels"], cfg)
    return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                             device=x.device)}


def init_cache(cfg: ModelConfig, B: int, S: int, device="cuda",
               dtype=torch.bfloat16):
    """Zero static cache: self K/V {"k", "v"} (L, B, S, K, hd) and cross
    K/V {"xk", "xv"} (L, B, T_enc, K, hd)."""
    L, K, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    shapes = {"k": (L, B, S, K, hd), "v": (L, B, S, K, hd),
              "xk": (L, B, cfg.encoder_seq_len, K, hd),
              "xv": (L, B, cfg.encoder_seq_len, K, hd)}
    return {n: torch.zeros(s, dtype=dtype, device=device)
            for n, s in shapes.items()}


def prefill_logits(params, batch, cfg: ModelConfig, head=None,
                   max_len=None):
    """The static prefill: batch frames (B, T_enc, d) and tokens (B, S).
    Returns (cache of ``max_len`` self positions (default S) holding the
    prompts' K/V in [0, S) and the cross K/V, the last position's logits
    (B, V_pad) fp32). ``head`` overrides the logits table."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed(params["embed"]["table"], tokens, cfg)
    enc_out = encode(params, batch["frames"].to(x.dtype), cfg)
    cos_sin = _rope(cfg, _arange_positions(B, S, tokens.device))
    scale = attention_scale(cfg)
    cache = init_cache(cfg, B, S if max_len is None else max_len,
                       tokens.device, x.dtype)

    def self_attend(ap, h, layer):
        q = project_q(ap, h, cfg, cos_sin)
        k, v = project_kv(ap, h, cfg, cos_sin)
        cache["k"][layer, :, :S] = k
        cache["v"][layer, :, :S] = v
        return sharded_attention(q, k, v, cfg, causal=True, scale=scale)

    def cross_attend(ap, h, layer):
        q = project_q(ap, h, cfg, None)
        k, v = project_kv(ap, enc_out, cfg, None)
        cache["xk"][layer] = k
        cache["xv"][layer] = v
        return sharded_attention(q, k, v, cfg, causal=False, scale=scale)

    x = _decoder(params, x, cfg, self_attend, cross_attend)
    head = head_table(params["embed"], cfg) if head is None else head
    return cache, decode_logits(x[:, -1:], head, cfg)


def prefill(params, batch, cfg: ModelConfig, head=None, max_len=None):
    """``prefill_logits`` with the greedy next token (B,) int32."""
    cache, logits = prefill_logits(params, batch, cfg, head, max_len)
    return cache, logits.argmax(dim=-1).to(torch.int32)


def decode_step(params, cache, batch, cfg: ModelConfig, head=None):
    """One token per sequence against the static cache: batch token (B,
    1), pos (B,) the self position to write at. The cross K/V is read only.
    Returns (greedy next token (B,) int32, cache)."""
    pos = batch["pos"]
    B = pos.shape[0]
    x = embed(params["embed"]["table"], batch["token"], cfg)
    cos_sin = _rope(cfg, pos[:, None])
    scale = attention_scale(cfg)
    full = torch.full((B,), cfg.encoder_seq_len - 1, dtype=torch.int32,
                      device=pos.device)

    def self_attend(ap, h, layer):
        q = project_q(ap, h, cfg, cos_sin)
        k, v = project_kv(ap, h, cfg, cos_sin)
        kc = update_cache(cache["k"][layer], k, pos)
        vc = update_cache(cache["v"][layer], v, pos)
        return decode_attention(q, kc, vc, pos, scale=scale)

    def cross_attend(ap, h, layer):
        q = project_q(ap, h, cfg, None)
        return decode_attention(q, cache["xk"][layer], cache["xv"][layer],
                                full, scale=scale)

    x = _decoder(params, x, cfg, self_attend, cross_attend)
    head = head_table(params["embed"], cfg) if head is None else head
    return decode_logits(x, head, cfg).argmax(dim=-1).to(torch.int32), cache


def prefill_chunk_paged(params, cache, batch, cfg: ModelConfig, head=None):
    """One chunk of decoder prompt prefill against the self-attention page
    pools and the chunk rows' cross K/V.

    batch: tokens (B, C), q_start (B,), q_lens (B,), block_tables (B, nb),
    ctx_lens (B,). cache: {"self": {"k", "v"} page pools (L, NB, bs, K,
    hd), "cross": {"xk", "xv"} (L, B, T_enc, K, hd), the chunk rows' slot
    rows}. Writes the chunk's self K/V in place. Returns (logits (B,
    V_pad) fp32 at each row's last valid token, cache)."""
    tokens = batch["tokens"]
    B, C = tokens.shape
    x = embed(params["embed"]["table"], tokens, cfg)
    q_start, q_lens = batch["q_start"], batch["q_lens"]
    positions = q_start[:, None] + torch.arange(C, dtype=q_start.dtype,
                                                device=tokens.device)
    cos_sin = _rope(cfg, positions)
    scale = attention_scale(cfg)
    bt, ctx_lens = batch["block_tables"], batch["ctx_lens"]
    pools, cross = cache["self"], cache["cross"]

    def self_attend(ap, h, layer):
        q = project_q(ap, h, cfg, cos_sin)
        k, v = project_kv(ap, h, cfg, cos_sin)
        K_l = pools["k"].shape[-2]
        kc = update_paged_cache_chunk(pools["k"][layer],
                                      local_kv_heads(k, K_l), bt, q_start,
                                      q_lens)
        vc = update_paged_cache_chunk(pools["v"][layer],
                                      local_kv_heads(v, K_l), bt, q_start,
                                      q_lens)
        return paged_chunk_attention(q, kc, vc, bt, ctx_lens, q_lens,
                                     scale=scale)

    def cross_attend(ap, h, layer):
        # no query-position dependence: the prefill's op sequence, chunk
        # by chunk
        q = project_q(ap, h, cfg, None)
        xk, xv = cross["xk"][layer], cross["xv"][layer]
        return over_local_heads(
            lambda ql: sharded_attention(ql, xk, xv, cfg, causal=False,
                                         scale=scale), q, xk.shape[2])

    x = _decoder(params, x, cfg, self_attend, cross_attend)
    head = head_table(params["embed"], cfg) if head is None else head
    last = (q_lens.long() - 1).clamp(0, C - 1)
    x_last = x[torch.arange(B, device=x.device), last][:, None]
    return decode_logits(x_last, head, cfg), cache


def decode_step_paged(params, cache, batch, cfg: ModelConfig, head=None):
    """One decode token per serving slot against the self-attention page
    pools and every slot's cross K/V: batch token (B, 1), pos (B,),
    block_tables (B, nb), ctx_lens (B,) (0: an idle slot). cache["cross"]
    holds one row per slot, (L, B, T_enc, K, hd). Returns (logits (B,
    V_pad) fp32, cache)."""
    pos = batch["pos"]
    B = pos.shape[0]
    x = embed(params["embed"]["table"], batch["token"], cfg)
    cos_sin = _rope(cfg, pos[:, None])
    scale = attention_scale(cfg)
    bt, ctx_lens = batch["block_tables"], batch["ctx_lens"]
    pools, cross = cache["self"], cache["cross"]
    full = torch.full((B,), cfg.encoder_seq_len - 1, dtype=torch.int32,
                      device=pos.device)

    def self_attend(ap, h, layer):
        q = project_q(ap, h, cfg, cos_sin)
        k, v = project_kv(ap, h, cfg, cos_sin)
        K_l = pools["k"].shape[-2]
        kc = update_paged_cache(pools["k"][layer], local_kv_heads(k, K_l),
                                bt, pos)
        vc = update_paged_cache(pools["v"][layer], local_kv_heads(v, K_l),
                                bt, pos)
        return paged_decode_attention(q, kc, vc, bt, ctx_lens, scale=scale)

    def cross_attend(ap, h, layer):
        q = project_q(ap, h, cfg, None)
        return decode_attention_local(q, cross["xk"][layer],
                                      cross["xv"][layer], full, scale=scale)

    x = _decoder(params, x, cfg, self_attend, cross_attend)
    head = head_table(params["embed"], cfg) if head is None else head
    return decode_logits(x, head, cfg), cache

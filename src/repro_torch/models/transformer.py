"""Decoder forward passes (port of ``repro.models.transformer``): the
paged serving trio ``decode_step_paged``, ``prefill_chunk_paged`` and
``prefill_chunk_ragged``, for dense GQA decoders (glm4, qwen3's qk-norm,
starcoder2's LayerNorm and ungated MLP, gemma2's alternating local and
global layers with softcaps, post-block norms and the embedding scale),
mixture-of-experts decoders (qwen3-moe, grok-1: ``models.moe`` in place
of the MLP), pure Mamba2 models and zamba2's hybrid (Mamba2 layers with
one shared attention + MLP block applied after every
``shared_attn_period`` layers); the static path ``init_cache`` /
``prefill`` / ``decode_step`` and the training loss ``forward_loss`` for
all of them and M-RoPE (qwen2-vl) decoders. The encoder-decoder (whisper)
is ``models.encdec``.

A Python loop over layers replaces ``lax.scan``. Parameters are a dict:
``{"embed": {"table"[, "head"]}, "layers": [per-layer dict, ...],
"final_norm": {"scale"}[, "shared": {...}]}``, where each per-layer dict is
one slice of the JAX package's stacked ``blocks/sub{i}`` trees: ``norm``,
``attn/{wq,wk,wv,wo[,q_norm,k_norm]}``, ``norm2``,
``mlp/{w_gate,w_in,w_out}`` (a MoE layer: ``moe/{router,w_gate,w_in,
w_out}``) [, ``post_norm``, ``post_norm2``] for an attention layer,
``norm``, ``mamba/{...}`` for a mamba layer (a LayerNorm carries
``bias`` beside ``scale``); ``shared``
is the hybrid's one unstacked attention block (``norm``, ``attn``,
``norm2``, ``mlp``).

The cache is a dict. Attention KV lives in ``{"k", "v"}`` page pools
shaped ``(n_attn, num_blocks, block_size, K, hd)``, one entry per
attention application in layer order (every layer of a dense model, one
per period of a hybrid), plus fp32 ``{"k_scale", "v_scale"}`` pools
``(..., K, 1)`` when the pools are int8 / fp8. Mamba state lives in
``{"conv", "ssm"}``: ``(n_mamba, rows, K-1, d_inner + 2 G N)`` in the
activation dtype and ``(n_mamba, rows, nh, hp, N)`` fp32, one row per
decode slot (the serving ``SlotStateCache``'s device half; a chunk gets
its slot's row). Every step writes its new KV rows and states into the
cache in place (the JAX package donates the buffers instead) and returns
it; into a quantized pool the rows are quantized first, their scale rows
scattered beside them, and the attention dequantizes. The static path's
cache is dense instead: ``{"k", "v"}`` ``(n_attn, B, S, K, hd)`` and
``{"conv", "ssm"}`` ``(n_mamba, B, ...)``, one row per sequence.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.config import LOCAL_ATTN, MAMBA, ModelConfig
from repro_torch.models import moe as moe_mod
from repro_torch.models import quant
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import (attention_scale, decode_attention,
                                          out_proj,
                                          paged_chunk_attention,
                                          local_kv_heads,
                                          paged_decode_attention, project_kv,
                                          project_q,
                                          ragged_chunk_update_attend,
                                          sharded_attention, train_attention,
                                          update_cache,
                                          update_paged_cache,
                                          update_paged_cache_chunk)
from repro_torch.models.embedding import (decode_logits,
                                          decode_logits_argmax, embed,
                                          head_table,
                                          lm_loss, sampled_softmax_loss)
from repro_torch.models.layers import apply_mlp, apply_norm, rope_cos_sin
from repro_torch.models.remat import MODES, remat
from repro_torch.spmd import collectives


def _post_norm(lp, name, y, cfg: ModelConfig):
    """A block output through its post-block norm (gemma2), before the
    residual add."""
    return apply_norm(lp[name], y, cfg) if cfg.post_block_norm else y


def _attn_part(lp, x, cfg: ModelConfig, attend):
    """The attention half of a block: ``attend`` maps the normed input to
    the attention output, which goes through ``out_proj`` and the
    post-block norm into the residual."""
    # a rank's heads (row parallel, in training or with sharded weights):
    # summed over "model"
    y = out_proj(lp["attn"], attend(apply_norm(lp["norm"], x, cfg)), x.dtype)
    y = collectives.reduce_from(y, collectives.shard_group(
        lp["attn"]["wo"].shape[0], cfg.num_heads, "out_proj's heads"))
    return x + _post_norm(lp, "post_norm", y, cfg)


def _mlp_part(lp, x, cfg: ModelConfig, post: bool = True,
              with_aux: bool = False):
    """The MLP half of a block: the MLP, or a MoE layer's ``moe`` block.
    The hybrid's shared block has no ``post_norm2`` (``post=False``), as
    in the JAX package. ``with_aux`` (training) returns (x, the MoE
    block's load-balance loss, 0 for an MLP)."""
    h = apply_norm(lp["norm2"], x, cfg)
    if "moe" in lp:
        out = moe_mod.moe_block(lp["moe"], h, cfg, with_aux=with_aux)
        y, aux = out if with_aux else (out, None)
    else:
        y, aux = apply_mlp(lp["mlp"], h, cfg), None
    x = x + (_post_norm(lp, "post_norm2", y, cfg) if post else y)
    if not with_aux:
        return x
    return x, (torch.zeros((), dtype=torch.float32, device=x.device)
               if aux is None else aux)


PAGE_POOLS = ("k", "v", "k_scale", "v_scale")
MOE_AUX_COEF = 0.01


def _refuse_mrope(cfg: ModelConfig, what: str) -> None:
    """The reference's refusal: M-RoPE takes per-request position streams,
    which a paged chunk does not carry."""
    if cfg.rope_sections is not None:
        raise ValueError(f"{cfg.name}: {what}: no M-RoPE frontends")


def period_structure(cfg: ModelConfig) -> tuple[tuple[str, ...], int]:
    """(kinds within one period, number of periods): the JAX package's
    layer stacking. A hybrid's period is ``shared_attn_period`` layers and
    one application of the shared block."""
    if cfg.shared_attn_period:
        P = cfg.shared_attn_period
        kinds = cfg.layer_kinds()[:P]
    else:
        kinds = cfg.block_pattern
        P = len(kinds)
    if cfg.num_layers % P:
        raise ValueError(f"{cfg.num_layers} layers are not a whole number "
                         f"of {P}-layer periods")
    return tuple(kinds), cfg.num_layers // P


def _layers(params, cache, cfg: ModelConfig, x, attend, mamba=None):
    """Run every layer in order. An attention application (a dense layer,
    or the hybrid's shared block after every ``shared_attn_period``
    layers) calls ``attend(ap, h, pools, window)``, which returns the
    attention output for normed input ``h`` after writing its KV into
    ``pools``, the application's slice of every page pool. A mamba layer
    calls ``mamba(mp, h, m)``, which returns the block output for normed
    input ``h`` after updating mamba layer ``m``'s state in the cache."""
    period = cfg.shared_attn_period
    n_attn = n_mamba = 0

    def attention(bp, x, window, shared=False):
        nonlocal n_attn
        pools = {n: cache[n][n_attn] for n in PAGE_POOLS if n in cache}
        n_attn += 1
        x = _attn_part(bp, x, cfg,
                       lambda h: attend(bp["attn"], h, pools, window))
        return _mlp_part(bp, x, cfg, post=not shared)

    for i, (lp, kind) in enumerate(zip(params["layers"], cfg.layer_kinds())):
        if kind == MAMBA:
            x = x + mamba(lp["mamba"], apply_norm(lp["norm"], x, cfg),
                          n_mamba)
            n_mamba += 1
        else:
            x = attention(lp, x, cfg.sliding_window if kind == LOCAL_ATTN
                          else None)
        if period and (i + 1) % period == 0:
            x = attention(params["shared"], x, None, shared=True)
    return apply_norm(params["final_norm"], x, cfg)


def _rope(cfg: ModelConfig, positions):
    """Rope tables for (B, S) or, with M-RoPE, (3, B, S) positions; None
    for an attention-free model."""
    if not cfg.num_heads:
        return None
    return rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                        cfg.rope_sections)


def _store_kv(pools, k, v, update, *args):
    """Write new K/V rows into a layer's pools with ``update(pool, rows,
    *args)``: quantized first for an int8/fp8 pool, whose scale rows go
    into the scale pools. With tensor parallelism only this rank's kv
    heads, the pools' own. Returns the attention's scale keywords."""
    K_l = pools["k"].shape[-2]
    k, v = local_kv_heads(k, K_l), local_kv_heads(v, K_l)
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


def _attn_kw(ap, cfg: ModelConfig, window) -> dict:
    """The paged attention's keywords for a layer's attention params
    ``ap``: its window, softcap and scale, and ``local_q`` where ``wq``
    holds a rank's shard of the query heads (sharded weights)."""
    return dict(window=window, cap=cfg.attn_logit_softcap,
                scale=attention_scale(cfg),
                local_q=ap["wq"].shape[1] != cfg.num_heads)


def decode_step_paged(params, cache, batch, cfg: ModelConfig, head=None):
    """One decode token against the paged KV cache (all serving slots).

    batch: token (B, 1), pos (B,) write position, block_tables (B, nb),
    ctx_lens (B,) visible tokens incl. this one (0 masks an idle slot).
    ``head`` overrides the logits table (an fp32 copy, see
    ``decode_logits``). Mamba layers run every slot (cache rows = B); the
    new state is written back for active slots only, so an idle slot
    (ctx_len 0) keeps its state. Returns (logits (B, V_pad) fp32, cache).
    """
    pos = batch["pos"]
    x = embed(params["embed"]["table"], batch["token"], cfg)
    cos_sin = _rope(cfg, pos[:, None])
    bt, ctx_lens = batch["block_tables"], batch["ctx_lens"]
    active = ctx_lens > 0

    def attend(ap, h, pools, window):
        q = project_q(ap, h, cfg, cos_sin)
        k, v = project_kv(ap, h, cfg, cos_sin)
        scales = _store_kv(pools, k, v, update_paged_cache, bt, pos)
        return paged_decode_attention(q, pools["k"], pools["v"], bt,
                                      ctx_lens, **_attn_kw(ap, cfg, window),
                                      **scales)

    def mamba(mp, h, m):
        conv, ssm = cache["conv"][m], cache["ssm"][m]
        y, (tail, hs) = ssm_mod.mamba_decode(mp, h, cfg, (conv, ssm))
        # write back active rows only: the where reads the old state
        # before the copy overwrites it
        conv.copy_(torch.where(active[:, None, None], tail, conv))
        ssm.copy_(torch.where(active[:, None, None, None], hs, ssm))
        return y

    x = _layers(params, cache, cfg, x, attend, mamba)
    head = head_table(params["embed"], cfg) if head is None else head
    return decode_logits(x, head, cfg), cache


def prefill_chunk_paged(params, cache, batch, cfg: ModelConfig, head=None,
                        *, all_logits: bool = False):
    """One chunk of prompt prefill against the paged KV cache.

    batch: tokens (B, C) the chunk's token slice (right-padded), q_start
    (B,) absolute position of column 0, q_lens (B,) valid columns,
    block_tables (B, nb), ctx_lens (B,) = q_start + q_lens. The cache's
    mamba state has one row per chunk row (the runner passes a view of the
    chunk's slot row), read as the previous chunk's state and overwritten
    with the new one.
    Returns (logits (B, V_pad) fp32 at each row's last valid token, cache).
    With ``all_logits=True`` the logits cover every chunk position, (B, C,
    V_pad): the speculative verify step scores all k + 1 candidate
    positions in one widened pass.
    """
    _refuse_mrope(cfg, "chunked prefill")
    tokens = batch["tokens"]
    B, C = tokens.shape
    x = embed(params["embed"]["table"], tokens, cfg)
    q_start, q_lens = batch["q_start"], batch["q_lens"]
    positions = q_start[:, None] + torch.arange(C, dtype=q_start.dtype,
                                                device=tokens.device)
    cos_sin = _rope(cfg, positions)
    bt, ctx_lens = batch["block_tables"], batch["ctx_lens"]

    def attend(ap, h, pools, window):
        q = project_q(ap, h, cfg, cos_sin)
        k, v = project_kv(ap, h, cfg, cos_sin)
        scales = _store_kv(pools, k, v, update_paged_cache_chunk, bt,
                           q_start, q_lens)
        return paged_chunk_attention(q, pools["k"], pools["v"], bt, ctx_lens,
                                     q_lens, **_attn_kw(ap, cfg, window),
                                     **scales)

    def mamba(mp, h, m):
        conv, ssm = cache["conv"][m], cache["ssm"][m]
        y, (tail, hs) = ssm_mod.mamba_chunk(mp, h, cfg, (conv, ssm), q_lens)
        conv.copy_(tail)
        ssm.copy_(hs)
        return y

    x = _layers(params, cache, cfg, x, attend, mamba)
    head = head_table(params["embed"], cfg) if head is None else head
    if all_logits:
        logits = decode_logits(x.reshape(B * C, 1, -1), head, cfg)
        return logits.reshape(B, C, -1), cache
    last = (q_lens.long() - 1).clamp(0, C - 1)
    x_last = x[torch.arange(B, device=x.device), last][:, None]   # (B,1,d)
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
    Attention-only: SSM and hybrid models carry per-sequence chunk state,
    which the flat layout does not, and are refused.
    Returns (logits (S, V_pad) fp32 at each sequence's last row, cache).
    """
    if cfg.ssm is not None or cfg.shared_attn_period:
        raise ValueError(f"{cfg.name}: packed prefill is attention-only "
                         "(SSM blocks need per-row chunk state)")
    _refuse_mrope(cfg, "packed prefill")
    tokens = batch["tokens"]
    T = tokens.shape[1]
    x = embed(params["embed"]["table"], tokens, cfg)
    cos_sin = _rope(cfg, batch["positions"])
    seqs = (batch["block_tables"], batch["ctx_lens"], batch["starts"],
            batch["ends"], batch["row_seq"])

    def attend(ap, h, pools, window):
        q = project_q(ap, h, cfg, cos_sin)
        k, v = project_kv(ap, h, cfg, cos_sin)
        scales = {n: pools[n] for n in ("k_scale", "v_scale") if n in pools}
        return ragged_chunk_update_attend(
            q, k, v, pools["k"], pools["v"], *seqs,
            **_attn_kw(ap, cfg, window), **scales)[0]

    x = _layers(params, cache, cfg, x, attend)
    last = (batch["ends"].long() - 1).clamp(0, T - 1)             # (S,)
    head = head_table(params["embed"], cfg) if head is None else head
    return decode_logits(x[0, last][:, None], head, cfg), cache


# ---------------------------------------------------------------------------
# The static path: monolithic prefill, then one token at a time against
# dense per-sequence caches (the JAX package's prefill / decode_step)
# ---------------------------------------------------------------------------


def check_static(cfg: ModelConfig) -> None:
    """Raise for the encoder-decoder, whose static path is
    ``models.encdec``'s (``models.api`` dispatches)."""
    if cfg.encoder_layers:
        raise ValueError(f"{cfg.name}: an encoder-decoder's static path "
                         "is models.encdec's (models.api dispatches)")


def layer_counts(cfg: ModelConfig) -> tuple[int, int]:
    """(attention applications, mamba layers) of one forward pass, the
    leading axes of the caches' attention and mamba entries."""
    n_mamba = sum(kind == MAMBA for kind in cfg.layer_kinds())
    n_attn = cfg.num_layers - n_mamba
    if cfg.shared_attn_period:
        n_attn += cfg.num_layers // cfg.shared_attn_period
    return n_attn, n_mamba


def init_cache(cfg: ModelConfig, B: int, S: int, device="cuda",
               dtype=torch.bfloat16):
    """Zero static cache: {"k", "v"} (n_attn, B, S, K, hd), one entry per
    attention application in layer order (every attention layer, and one
    per period for a hybrid's shared block), and for mamba layers
    {"conv" (n_mamba, B, K-1, d_inner + 2 G N) in ``dtype``, "ssm"
    (n_mamba, B, nh, hp, N) fp32}, one entry per mamba layer."""
    check_static(cfg)
    n_attn, n_mamba = layer_counts(cfg)
    cache = {}
    if n_attn:
        shape = (n_attn, B, S, cfg.num_kv_heads, cfg.head_dim)
        for n in ("k", "v"):
            cache[n] = torch.zeros(shape, dtype=dtype, device=device)
    if n_mamba:
        s, d = cfg.ssm, cfg.d_model
        conv = s.d_inner(d) + 2 * s.n_groups * s.state_dim
        cache["conv"] = torch.zeros((n_mamba, B, s.conv_kernel - 1, conv),
                                    dtype=dtype, device=device)
        cache["ssm"] = torch.zeros((n_mamba, B, s.n_heads(d), s.head_dim,
                                    s.state_dim), dtype=torch.float32,
                                   device=device)
    return cache


def prefill(params, batch, cfg: ModelConfig, head=None, max_len=None):
    """Process equal-length prompts: batch tokens (B, S) [, positions (B,
    S), or (3, B, S) for M-RoPE]. Every attention application attends
    through ``sharded_attention`` (the flash kernel on the card); every
    mamba layer runs ``ssm.mamba_block`` over the whole chunk-padded
    prompt (the ssd kernel on the card). Returns (cache: {"k", "v"}
    (n_attn, B, max_len, K, hd) holding the prompts' K/V in positions [0,
    S) and zeros after them (``max_len`` defaults to S), and each mamba
    layer's conv tail and final state, greedy next token (B,) int32).
    ``head`` overrides the logits table, as in ``decode_step_paged``."""
    cache, logits = prefill_logits(params, batch, cfg, head, max_len)
    return cache, logits.argmax(dim=-1).to(torch.int32)


def prefill_logits(params, batch, cfg: ModelConfig, head=None, max_len=None):
    """``prefill`` with the last position's logits (B, V_pad) fp32 in
    place of its greedy token."""
    check_static(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed(params["embed"]["table"], tokens, cfg)
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None].expand(B, S)
    cos_sin = _rope(cfg, positions)
    cache = init_cache(cfg, B, S if max_len is None else max_len,
                       tokens.device, x.dtype)

    def attend(ap, h, pools, window):
        q = project_q(ap, h, cfg, cos_sin)
        k, v = project_kv(ap, h, cfg, cos_sin)
        pools["k"][:, :S] = k
        pools["v"][:, :S] = v
        return sharded_attention(q, k, v, cfg, causal=True, window=window,
                                 cap=cfg.attn_logit_softcap,
                                 scale=attention_scale(cfg))

    def mamba(mp, h, m):
        y, (tail, hs) = ssm_mod.mamba_block(mp, h, cfg)
        cache["conv"][m].copy_(tail)
        cache["ssm"][m].copy_(hs)
        return y

    x = _layers(params, cache, cfg, x, attend, mamba)
    head = head_table(params["embed"], cfg) if head is None else head
    return cache, decode_logits(x[:, -1:], head, cfg)


def decode_step(params, cache, batch, cfg: ModelConfig, head=None):
    """One token per sequence against the static cache: batch token (B,
    1), pos (B,) the position to write at (the token attends to [0, pos]).
    Writes the new K/V rows and each mamba layer's new conv tail and state
    into ``cache`` in place. Returns (greedy next token (B,) int32,
    cache)."""
    check_static(cfg)
    pos = batch["pos"]
    B = pos.shape[0]
    x = embed(params["embed"]["table"], batch["token"], cfg)
    # M-RoPE: the new token's id on all three planes
    cos_sin = _rope(cfg, pos[None, :, None].expand(3, B, 1)
                    if cfg.rope_sections is not None else pos[:, None])

    def attend(ap, h, pools, window):
        q = project_q(ap, h, cfg, cos_sin)
        k, v = project_kv(ap, h, cfg, cos_sin)
        kc = update_cache(pools["k"], k, pos)
        vc = update_cache(pools["v"], v, pos)
        return decode_attention(q, kc, vc, pos, window=window,
                                cap=cfg.attn_logit_softcap,
                                scale=attention_scale(cfg))

    def mamba(mp, h, m):
        conv, ssm = cache["conv"][m], cache["ssm"][m]
        y, (tail, hs) = ssm_mod.mamba_decode(mp, h, cfg, (conv, ssm))
        conv.copy_(tail)
        ssm.copy_(hs)
        return y

    x = _layers(params, cache, cfg, x, attend, mamba)
    head = head_table(params["embed"], cfg) if head is None else head
    return decode_logits_argmax(x, head, cfg), cache


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def check_trainable(cfg: ModelConfig, pcfg) -> None:
    """Raise for a remat mode the JAX package does not have. Every decoder
    family trains here (``models.encdec`` trains the encoder-decoder)."""
    if pcfg.remat not in MODES:
        raise ValueError(f"remat={pcfg.remat!r}: one of {MODES}")


def _attn_full(lp, x, cfg: ModelConfig, cos_sin, window):
    """Full-sequence causal self attention of one block (train mode;
    ``train_attention``: the rank's heads under tensor parallelism)."""
    return _attn_part(lp, x, cfg, lambda h: train_attention(
        lp["attn"], h, cfg, cos_sin, window))


def _train_layer(lp, kind, cfg, cos_sin, x):
    """One layer: (x, aux)."""
    if kind == MAMBA:
        y, _ = ssm_mod.mamba_block(lp["mamba"], apply_norm(lp["norm"], x, cfg),
                                   cfg)
        return x + y, torch.zeros((), dtype=torch.float32, device=x.device)
    window = cfg.sliding_window if kind == LOCAL_ATTN else None
    return _mlp_part(lp, _attn_full(lp, x, cfg, cos_sin, window), cfg,
                     with_aux=True)


def _train_period(layers, kinds, shared, cfg, cos_sin, x):
    """A hybrid's period: its mamba layers, then the shared attention and
    MLP block (no post-block norms). Returns (x, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp, kind in zip(layers, kinds):
        x, a = _train_layer(lp, kind, cfg, cos_sin, x)
        aux = aux + a
    x = _attn_full(shared, x, cfg, cos_sin, None)
    x, a = _mlp_part(shared, x, cfg, post=False, with_aux=True)
    return x, aux + a


def _train_units(params, cfg: ModelConfig, cos_sin):
    """The forward's remat units in order, each a function x -> (x, aux):
    one per layer, or for a hybrid one per period (the JAX package
    checkpoints its scanned period body; for a dense model a layer and a
    period compute the same values)."""
    kinds = cfg.layer_kinds()
    P = cfg.shared_attn_period
    if P:
        return [functools.partial(_train_period, params["layers"][i:i + P],
                                  kinds[i:i + P], params["shared"], cfg,
                                  cos_sin)
                for i in range(0, cfg.num_layers, P)]
    return [functools.partial(_train_layer, lp, kind, cfg, cos_sin)
            for lp, kind in zip(params["layers"], kinds)]


def forward_loss(params, batch, cfg: ModelConfig, pcfg, sampled_ids=None):
    """Training loss of a decoder: dense, mixture-of-experts, M-RoPE, pure
    Mamba2 or hybrid. batch: tokens (B, S), labels (B, S) [, positions
    (B, S), or (3, B, S) for M-RoPE]. Returns (loss, {"ce", "aux"}): loss
    = ce + MOE_AUX_COEF * aux, aux the MoE layers' load-balance losses
    summed (0 without experts). ``pcfg.remat`` wraps each remat unit
    (``models.remat``: "none", "full" or "dots")."""
    check_trainable(cfg, pcfg)
    tokens, labels = batch["tokens"], batch["labels"]
    B, S = tokens.shape
    x = embed(params["embed"]["table"], tokens, cfg)
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None].expand(B, S)
    cos_sin = _rope(cfg, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for unit in _train_units(params, cfg, cos_sin):
        x, a = remat(unit, pcfg.remat)(x)
        aux = aux + a
    x = apply_norm(params["final_norm"], x, cfg)
    ht = head_table(params["embed"], cfg)
    if sampled_ids is not None:
        ce = sampled_softmax_loss(x, ht, labels, sampled_ids, cfg)
    else:
        ce = lm_loss(x, ht, labels, cfg)
    return ce + MOE_AUX_COEF * aux, {"ce": ce, "aux": aux}

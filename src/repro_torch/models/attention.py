"""GQA projections and paged attention for serving (port of the serving
half of ``repro.models.attention``).

Weights keep the JAX package's einsum layouts (``wq (d, H, hd)``,
``wk/wv (d, K, hd)``, ``wo (H, hd, d)``) and run as plain matrix products
over the flattened head axes. Page pools are updated in place where the
JAX package donates them: ``update_paged_cache*`` write into the pool they
are given and return it.
"""

from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, softcap

NEG_INF = -1.0e30


def project_q(params, x, cfg: ModelConfig, cos_sin=None):
    B, S, d = x.shape
    w = params["wq"].to(x.dtype).reshape(d, -1)
    q = (x @ w).reshape(B, S, cfg.num_heads, cfg.head_dim)
    if cos_sin is not None:
        q = apply_rope(q, *cos_sin)
    return q


def project_kv(params, x, cfg: ModelConfig, cos_sin=None):
    B, S, d = x.shape
    shape = (B, S, cfg.num_kv_heads, cfg.head_dim)
    k = (x @ params["wk"].to(x.dtype).reshape(d, -1)).reshape(shape)
    v = (x @ params["wv"].to(x.dtype).reshape(d, -1)).reshape(shape)
    if cos_sin is not None:
        k = apply_rope(k, *cos_sin)
    return k, v


def out_proj(params, y, x_dtype):
    B, S, H, hd = y.shape
    return y.reshape(B, S, H * hd) @ params["wo"].to(x_dtype).reshape(
        H * hd, -1)


def attention_scale(cfg: ModelConfig) -> float:
    return cfg.attn_scale if cfg.attn_scale is not None else cfg.head_dim ** -0.5


def update_paged_cache(pages, new, block_tables, pos):
    """Scatter one new KV row per sequence into its block-table page, in
    place. pages: (num_blocks, block_size, K, hd); new: (B, 1, K, hd); pos:
    (B,) absolute write position. Inactive slots carry all-zero table rows,
    so their writes land in the reserved trash block 0."""
    bs = pages.shape[1]
    pos = pos.long()
    blk = torch.gather(block_tables.long(), 1, (pos // bs)[:, None])[:, 0]
    pages[blk, pos % bs] = new[:, 0].to(pages.dtype)
    return pages


def update_paged_cache_chunk(pages, new, block_tables, q_start, q_lens):
    """Scatter a chunk of KV rows per sequence into its pages, in place.
    pages: (num_blocks, block_size, K, hd); new: (B, C, K, hd); q_start:
    (B,) absolute position of chunk row 0; q_lens: (B,) valid rows. Rows
    past q_lens go to the trash block 0."""
    bs = pages.shape[1]
    B, C = new.shape[:2]
    nb = block_tables.shape[1]
    pos = q_start.long()[:, None] + torch.arange(C, device=new.device)[None]
    idx = (pos // bs).clamp(0, nb - 1)
    blk = torch.gather(block_tables.long(), 1, idx)
    valid = torch.arange(C, device=new.device)[None] < q_lens.long()[:, None]
    blk = torch.where(valid, blk, 0)
    pages[blk.reshape(-1), (pos % bs).reshape(-1)] = new.reshape(
        B * C, *new.shape[2:]).to(pages.dtype)
    return pages


def paged_decode_attention(q, k_pages, v_pages, block_tables, ctx_lens, *,
                           window=None, cap=None, scale=None):
    """Decode attention via block tables. q: (B, 1, H, hd) -> (B, 1, H, hd)."""
    o = ops.paged_attention(q[:, 0].contiguous(), k_pages, v_pages,
                            block_tables, ctx_lens, window=window, cap=cap,
                            scale=scale)
    return o[:, None].to(q.dtype)


def paged_chunk_attention(q, k_pages, v_pages, block_tables, ctx_lens,
                          q_lens, *, window=None, cap=None, scale=None):
    """Chunked-prefill attention via block tables: the C queries of one
    prompt chunk attend causally to the paged context (this chunk's KV
    already scattered in). q: (B, C, H, hd) -> (B, C, H, hd)."""
    o = ops.paged_prefill_attention(q.contiguous(), k_pages, v_pages,
                                    block_tables, ctx_lens, q_lens,
                                    window=window, cap=cap, scale=scale)
    return o.to(q.dtype)


def paged_chunk_attention_xla(q, k_pages, v_pages, block_tables, ctx_lens,
                              q_lens, *, window=None, cap=None, scale=None):
    """Plain chunked-prefill path (the JAX package's XLA path, op for op):
    densify the block-table gather, fp32 logits, softmax normalized in fp32
    and cast to the value dtype, then p @ v. Padding rows (i >= q_lens)
    emit garbage; their KV went to the trash block and the engine discards
    their logits."""
    B, C, H, hd = q.shape
    _, bs, K, _ = k_pages.shape
    G = H // K
    scale = hd ** -0.5 if scale is None else scale
    bt = block_tables.long()
    k = k_pages[bt].reshape(B, -1, K, hd)
    v = v_pages[bt].reshape(B, -1, K, hd)
    S = k.shape[1]
    qg = q.reshape(B, C, G, K, hd)
    logits = torch.einsum("bqgkh,bskh->bgkqs", qg.float(), k.float()) * scale
    logits = softcap(logits, cap)
    dev = q.device
    q_pos = (ctx_lens - q_lens).long()[:, None] + torch.arange(C, device=dev)
    d = q_pos[..., None] - torch.arange(S, device=dev)[None, None]
    ok = d >= 0
    if window is not None:
        ok &= d < window
    logits = torch.where(ok[:, None, None], logits, NEG_INF)
    mx = logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits - mx)
    p = (e / e.sum(dim=-1, keepdim=True)).to(v.dtype)
    o = torch.einsum("bgkqs,bskh->bqgkh", p, v)
    return o.reshape(B, C, H, hd).to(q.dtype)

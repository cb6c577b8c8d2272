"""GQA projections and paged attention for serving (port of the serving
half of ``repro.models.attention``).

Weights keep the JAX package's einsum layouts (``wq (d, H, hd)``,
``wk/wv (d, K, hd)``, ``wo (H, hd, d)``) and run as plain matrix products
over the flattened head axes. Page pools are updated in place where the
JAX package donates them: ``update_paged_cache*`` write into the pool they
are given and return it, and so does the fused packed-prefill op.

Quantized pools (int8 / fp8, ``models.quant``) take only rows already
quantized to their dtype: the callers quantize new K/V first and scatter
its scale rows into the fp32 scale pools, and the attention paths
dequantize after the gather (plain) or in-tile (kernels).

Tensor-parallel serving (a ``spmd.collectives`` model group current, of
size tp > 1): the pools and the cross K/V hold this rank's K / tp kv heads
(``local_kv_heads`` cuts new K/V rows to them before a write). The paged
and cross attention paths attend this rank's heads only, all G query heads
of each local kv head (g-major: q heads g * K + k), and ``gather_heads``
restores every head in the global order before ``out_proj``: an exact
gather, so every contraction across heads runs whole on every rank and the
outputs are the same bits on any tp (the JAX package's
``replicate_over_model``). With sharded weights (the engine's
``shard_params=True``: ``wq`` / ``wk`` / ``wv`` hold the rank's heads,
``spmd.sharding``'s kv-group cut) the projections give the rank's heads
only, the attention takes them as they are (``local_q=True``: no
narrowing, no gather), and ``out_proj`` over the rank's rows of ``wo``
is a partial sum that the block sums over the group (row parallel, as in
training). ``paged_shard_attention`` is the other sharding, of the
blocks axis: per-shard partial softmaxes over disjoint pages,
LSE-stitched.

Tensor-parallel training (a ``spmd.collectives`` training mesh current,
its "model" group of size tp > 1): the weights are the rank's shards
(``spmd.sharding``'s kv-group cut of the query heads), ``project_q`` /
``project_kv`` project its heads, ``train_attention`` attends them
(``train_split``), and the caller sums ``out_proj`` over the group;
``sharded_attention`` splits the query rows where tp divides neither
head count (docs/torch-training-mesh.md).
"""

from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import causal_mask
from repro_torch.models import quant
from repro_torch.models.layers import apply_rope, rms_norm_fp32, softcap
from repro_torch.spmd import collectives

NEG_INF = -1.0e30


def project_q(params, x, cfg: ModelConfig, cos_sin=None):
    """(B, S, H, hd) queries; H the heads ``wq`` holds (a training rank's
    shard holds H / tp)."""
    B, S, d = x.shape
    w = params["wq"].to(x.dtype).reshape(d, -1)
    q = (x @ w).reshape(B, S, -1, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm_fp32(q, params["q_norm"])
    if cos_sin is not None:
        q = apply_rope(q, *cos_sin)
    return q


def project_kv(params, x, cfg: ModelConfig, cos_sin=None):
    B, S, d = x.shape
    shape = (B, S, -1, cfg.head_dim)
    k = (x @ params["wk"].to(x.dtype).reshape(d, -1)).reshape(shape)
    v = (x @ params["wv"].to(x.dtype).reshape(d, -1)).reshape(shape)
    if cfg.qk_norm:
        k = rms_norm_fp32(k, params["k_norm"])
    if cos_sin is not None:
        k = apply_rope(k, *cos_sin)
    return k, v


def out_proj(params, y, x_dtype):
    B, S, H, hd = y.shape
    return y.reshape(B, S, H * hd) @ params["wo"].to(x_dtype).reshape(
        H * hd, -1)


def attention_scale(cfg: ModelConfig) -> float:
    return cfg.attn_scale if cfg.attn_scale is not None else cfg.head_dim ** -0.5


def _model_group():
    """The current model group when it shards (tp > 1), else None."""
    g = collectives.current()
    return g if g is not None and g.size > 1 else None


def local_kv_heads(x, held: int, dim: int = -2):
    """This rank's ``held`` kv heads of ``x`` along ``dim`` (its K / tp
    contiguous heads), or ``x`` itself without tensor parallelism or where
    it holds just those (a sharded projection's)."""
    g = _model_group()
    if g is None or x.shape[dim] == held:
        return x
    return x.narrow(dim, g.rank * held, held)


def _local_q(q, k_local: int):
    """q (..., H, hd) -> the query heads of this rank's ``k_local`` kv
    heads, (..., G * k_local, hd) g-major: heads g * K + k for the rank's
    k."""
    g = _model_group()
    *lead, H, hd = q.shape
    K = k_local * g.size
    qg = q.reshape(*lead, H // K, K, hd)
    return qg.narrow(-2, g.rank * k_local, k_local).reshape(
        *lead, (H // K) * k_local, hd)


def gather_heads(o, k_local: int):
    """(..., G * k_local, hd) per-rank heads -> (..., H, hd), every rank's
    in the global g-major order: the counterpart of the JAX package's
    ``replicate_over_model``, an exact gather before any contraction
    across heads."""
    g = _model_group()
    if g is None:
        return o
    *lead, Hl, hd = o.shape
    G = Hl // k_local
    full = g.gather(o.reshape(*lead, G, k_local, hd), dim=-2)
    return full.reshape(*lead, G * k_local * g.size, hd)


def over_local_heads(attend, q, k_local: int, local_q: bool = False):
    """``attend(q)`` over this rank's kv heads with tensor parallelism
    (q cut to their query heads, the result gathered to all H), else
    ``attend(q)``. ``local_q``: q holds those query heads already (a
    sharded projection's), and so does the result."""
    if _model_group() is None or local_q:
        return attend(q)
    return gather_heads(attend(_local_q(q, k_local).contiguous()), k_local)


def dense_attention(q, k, v, *, causal=True, window=None, cap=None,
                    scale=None, q_offset=0):
    """Full-sequence GQA attention, the JAX package's plain path (port of
    ``repro.models.attention.dense_attention``). q (B, Sq, H, hd), k/v (B,
    Skv, K, hd); g-major heads (q head h reads kv head h % K). The
    rounding convention: fp32 logits from the inputs' exact products,
    softcap, mask, fp32 softmax, probabilities cast to v's dtype, then p v
    in v's dtype. Query row i sits at absolute position q_offset + i."""
    B, Sq, H, hd = q.shape
    _, Skv, K, _ = k.shape
    G = H // K
    scale = hd ** -0.5 if scale is None else scale
    qg = q.reshape(B, Sq, G, K, hd)
    logits = torch.einsum("bqgkh,bskh->bgkqs", qg.float(), k.float()) * scale
    logits = softcap(logits, cap)
    if causal:
        logits = torch.where(causal_mask(Sq, Skv, window, q_offset, q.device),
                             logits, NEG_INF)
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.einsum("bgkqs,bskh->bqgkh", p, v)
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def sharded_attention(q, k, v, cfg: ModelConfig, *, causal=True, window=None,
                      cap=None, scale=None):
    """Full-sequence attention (train / prefill; ``causal=False`` for
    whisper's encoder and cross attention) through ``ops.flash_attention``
    (port of the JAX package's ``sharded_attention``). Its
    sequence-parallel fallback: in training under a "model" group that
    does not divide the head count (q, k, v then whole on every rank),
    each rank attends its contiguous block of query rows against all
    keys (the flash kernel's ``q_offset``) and the rows are gathered; q,
    k and v enter through ``copy_to``, so their gradients, each rank's
    part, are summed."""
    kw = dict(causal=causal, window=window, cap=cap, scale=scale)
    grp = collectives.tp_group()
    Sq = q.shape[1]
    if grp is None or cfg.num_heads % grp.size == 0 or Sq % grp.size:
        return ops.flash_attention(q, k, v, **kw)
    n = Sq // grp.size
    q, k, v = (collectives.copy_to(t, grp) for t in (q, k, v))
    o = ops.flash_attention(q[:, grp.rank * n:(grp.rank + 1) * n], k, v,
                            q_offset=grp.rank * n, **kw)
    return collectives.gather_seq(o, grp, 1)


def train_split(cfg: ModelConfig, tp: int) -> str | None:
    """How a training block's attention splits over ``tp`` model ranks:
    None (tp 1); "kv" where tp divides K (each rank its K / tp kv heads
    and their query heads, ``spmd.sharding``'s kv-group cut); "heads"
    where it divides H only (contiguous query heads, the kv heads whole on
    every rank); "seq" otherwise (``sharded_attention``'s fallback; the
    attention weights whole on every rank)."""
    if tp <= 1:
        return None
    if cfg.num_kv_heads % tp == 0:
        return "kv"
    return "heads" if cfg.num_heads % tp == 0 else "seq"


def train_attention(params, h, cfg: ModelConfig, cos_sin, window=None):
    """Causal self attention of a training block over its normed input h
    (B, S, d), before ``out_proj``: the rank's heads under a sharding
    "model" group (Megatron-style column parallel; ``out_proj``'s result
    is then summed over the group), else every head. The replicated
    input, and the qk-norm scales applied to the rank's heads only, enter
    through ``collectives.copy_to``."""
    grp = collectives.tp_group()
    split = train_split(cfg, grp.size if grp is not None else 1)
    kw = dict(causal=True, window=window, cap=cfg.attn_logit_softcap,
              scale=attention_scale(cfg))
    if split in (None, "seq"):
        q = project_q(params, h, cfg, cos_sin)
        k, v = project_kv(params, h, cfg, cos_sin)
        return sharded_attention(q, k, v, cfg, **kw)
    p = dict(params)
    names = ("q_norm", "k_norm") if split == "kv" else ("q_norm",)
    for n in names:
        if n in p:
            p[n] = collectives.copy_to(p[n], grp)
    hq = collectives.copy_to(h, grp)
    q = project_q(p, hq, cfg, cos_sin)
    if split == "kv":
        k, v = project_kv(p, hq, cfg, cos_sin)
    else:
        # every kv head on every rank: each local query head's own
        Hl = q.shape[2]
        idx = (grp.rank * Hl + torch.arange(Hl, device=h.device)) \
            % cfg.num_kv_heads
        k, v = (collectives.copy_to(t, grp)[:, :, idx]
                for t in project_kv(p, h, cfg, cos_sin))
    return ops.flash_attention(q, k, v, **kw)


def block_causal_attention(q, k, v, *, window=None, cap=None, scale=None,
                           chunk_kv=1024, block_q=2048, q_offset=0):
    """Causal self attention with static triangular block skipping (port
    of the JAX package's plain path beyond ``DENSE_ATTN_MAX_KV`` keys):
    the query rows are cut into ``block_q`` blocks, and block i attends
    through ``chunked_attention`` to the key prefix it can see only (with
    a window, from the first chunk that holds a key in it)."""
    B, Sq, H, hd = q.shape
    if q_offset != 0 or Sq != k.shape[1]:
        raise ValueError("block_causal_attention: self-attention prefill "
                         "only (q_offset 0, Sq == Skv)")
    outs = []
    for lo in range(0, Sq, block_q):
        hi = min(lo + block_q, Sq)
        start = 0
        if window is not None:
            start = max(0, (lo - window) // chunk_kv * chunk_kv)
        outs.append(chunked_attention(
            q[:, lo:hi], k[:, start:hi], v[:, start:hi], causal=True,
            window=window, cap=cap, scale=scale, chunk_kv=chunk_kv,
            q_offset=lo - start))
    return torch.cat(outs, dim=1)


def chunked_attention(q, k, v, *, causal=True, window=None, cap=None,
                      scale=None, chunk_kv=1024, q_offset=0):
    """GQA attention streamed over ``chunk_kv``-key chunks with an online
    (max, sum, acc) softmax in fp32, so the logits held at once are (Sq,
    chunk_kv) per head (port of the JAX package's ``chunked_attention``).
    q (B, Sq, H, hd), k/v (B, Skv, K, hd), g-major heads; query row i at
    absolute position q_offset + i. fp32 logits of the exact products,
    softcap, mask; each chunk's probabilities cast to v's dtype before p v,
    summed in fp32."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    scale = hd ** -0.5 if scale is None else scale
    chunk_kv = min(chunk_kv, Skv)
    qg = q.reshape(B, Sq, G, K, hd).float()
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    mx = torch.full((B, Sq, G, K), NEG_INF, dtype=torch.float32,
                    device=q.device)
    sm = torch.zeros((B, Sq, G, K), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, G, K, hd), dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, Skv, chunk_kv):
        # the last chunk is zero-padded to chunk_kv keys, as in the JAX
        # package, and its padding masked
        k_i, v_i = k[:, c0:c0 + chunk_kv], v[:, c0:c0 + chunk_kv]
        pad = chunk_kv - k_i.shape[1]
        if pad:
            k_i = torch.nn.functional.pad(k_i, (0, 0, 0, 0, 0, pad))
            v_i = torch.nn.functional.pad(v_i, (0, 0, 0, 0, 0, pad))
        k_pos = c0 + torch.arange(chunk_kv, device=q.device)
        logits = torch.einsum("bqgkh,bckh->bqgkc", qg, k_i.float()) * scale
        logits = softcap(logits, cap)
        valid = (k_pos < Skv)[None, :]
        if causal:
            d = q_pos[:, None] - k_pos[None, :]
            ok = d >= 0
            if window is not None:
                ok &= d < window
            valid = valid & ok
        logits = torch.where(valid[None, :, None, None, :], logits, NEG_INF)
        new_mx = torch.maximum(mx, logits.amax(dim=-1))
        p = torch.exp(logits - new_mx[..., None])
        corr = torch.exp(mx - new_mx)
        sm = sm * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bqgkc,bckh->bqgkh", p.to(v.dtype).float(), v_i.float())
        mx = new_mx
    out = acc / sm.clamp(min=1e-37)[..., None]
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def update_cache(cache, new, pos):
    """Write one new KV row per sequence into a dense static cache, in
    place. cache: (B, S, K, hd); new: (B, 1, K, hd); pos: (B,) write
    position, clamped into [0, S) as ``dynamic_update_slice`` clamps it."""
    B, S = cache.shape[:2]
    rows = torch.arange(B, device=cache.device)
    cache[rows, pos.long().clamp(0, S - 1)] = new[:, 0].to(cache.dtype)
    return cache


def decode_attention(q, k_cache, v_cache, pos, *, window=None, cap=None,
                     scale=None):
    """One query per sequence against a dense static cache (port of the
    JAX package's ``decode_attention`` on one device, where its
    sequence-sharded stitch is the identity: ``_decode_attn_local`` over
    the whole cache). q: (B, 1, H, hd); caches: (B, S, K, hd); pos: (B,)
    the newest token's position (keys [0, pos] are visible, and with a
    window only those after pos - window). fp32 logits of the exact
    products, softcap, mask, the softmax normalized in fp32 and cast to
    the value dtype, then p v summed in fp32."""
    B, _, H, hd = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    scale = hd ** -0.5 if scale is None else scale
    qg = q.reshape(B, G, K, hd)
    logits = torch.einsum("bgkh,bskh->bgks", qg.float(),
                          k_cache.float()) * scale
    logits = softcap(logits, cap)
    k_pos = torch.arange(S, device=q.device)
    ok = k_pos[None, :] <= pos.long()[:, None]                    # (B, S)
    if window is not None:
        ok &= k_pos[None, :] > pos.long()[:, None] - window
    logits = torch.where(ok[:, None, None, :], logits, NEG_INF)
    mx = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - mx)
    sm = p.sum(dim=-1, keepdim=True).clamp(min=1e-37)
    o = torch.einsum("bgks,bskh->bgkh", (p / sm).to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, 1, H, hd).to(q.dtype)


def dense_as_pages(cache):
    """A dense (B, S, K, hd) cache as a page pool of B * S / bs pages of
    bs rows (a view; bs the largest divisor of S up to the kernels' 32)
    and its block tables (B, S / bs) int32: sequence b owns pages b * nb
    .. b * nb + nb - 1, in order."""
    B, S = cache.shape[:2]
    bs = max(d for d in range(1, 33) if S % d == 0)
    nb = S // bs
    tables = torch.arange(B * nb, dtype=torch.int32,
                          device=cache.device).reshape(B, nb)
    return cache.reshape(B * nb, bs, *cache.shape[2:]), tables


def decode_attention_local(q, k_cache, v_cache, pos, *, window=None,
                           cap=None, scale=None):
    """The JAX package's unsharded decode attention (its whisper decode's
    cross attention, against all T_enc keys with ``pos = T_enc - 1``):
    ``decode_attention``'s function, run as paged decode over the dense
    caches viewed as pages (``dense_as_pages``): the decode kernel on the
    card, ``paged_attention_ref`` (``decode_attention``'s op sequence) on
    the CPU. A row's bits on the card then do not depend on how many
    heads share the launch, as a batched GEMM's split of its 1500-key
    sums does. With tensor parallelism the caches hold this rank's kv
    heads: it attends those and gathers. q (B, 1, H, hd)."""
    k_pages, tables = dense_as_pages(k_cache)
    v_pages, _ = dense_as_pages(v_cache)
    ctx = (pos + 1).to(torch.int32)
    o = over_local_heads(
        lambda qh: ops.paged_attention(qh, k_pages, v_pages, tables, ctx,
                                       window=window, cap=cap, scale=scale),
        q[:, 0].contiguous(), k_cache.shape[2])
    return o[:, None].to(q.dtype)


def _scatter(pages, blk, slot, rows):
    """pages[blk, slot] = rows, in place. A narrow (int8/fp8) pool takes
    only rows already quantized to its dtype, copied byte for byte; a
    float row given to it would be truncated, so it raises."""
    if pages.dtype.itemsize == 1:
        if rows.dtype != pages.dtype:
            raise TypeError(
                f"{rows.dtype} rows into a {pages.dtype} pool: quantize "
                "them first (models.quant.quantize_kv)")
        pages.view(torch.uint8)[blk, slot] = rows.view(torch.uint8)
    else:
        pages[blk, slot] = rows.to(pages.dtype)
    return pages


def update_paged_cache(pages, new, block_tables, pos):
    """Scatter one new KV row per sequence into its block-table page, in
    place. pages: (num_blocks, block_size, K, hd); new: (B, 1, K, hd); pos:
    (B,) absolute write position. Inactive slots carry all-zero table rows,
    so their writes land in the reserved trash block 0."""
    bs = pages.shape[1]
    pos = pos.long()
    blk = torch.gather(block_tables.long(), 1, (pos // bs)[:, None])[:, 0]
    return _scatter(pages, blk, pos % bs, new[:, 0])


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
    return _scatter(pages, blk.reshape(-1), (pos % bs).reshape(-1),
                    new.reshape(B * C, *new.shape[2:]))


def update_paged_cache_ragged(pages, new, block_tables, ctx_lens, starts,
                              ends, row_seq):
    """Scatter a packed (ragged) multi-sequence chunk of KV into pages, in
    place. pages: (num_blocks, block_size, K, hd); new: (1, T, K, hd), the
    chunks of up to S sequences back to back: sequence s owns flat rows
    [starts[s], ends[s]) and row_seq maps each flat row to its owner. Flat
    row t lands at absolute position ``ctx_lens[s] - (ends[s] - starts[s])
    + (t - starts[s])`` in sequence s's block table; rows owned by nobody
    go to the trash block 0, as in ``update_paged_cache_chunk``."""
    bs = pages.shape[1]
    T = new.shape[1]
    nb = block_tables.shape[1]
    t = torch.arange(T, device=new.device)
    rs = row_seq.long()
    st, en = starts.long(), ends.long()
    q_start = (ctx_lens.long() - (en - st))[rs]
    valid = (t >= st[rs]) & (t < en[rs])
    pos = torch.where(valid, q_start + (t - st[rs]), 0)
    idx = (pos // bs).clamp(0, nb - 1)
    blk = torch.where(valid, block_tables.long()[rs, idx], 0)
    return _scatter(pages, blk, pos % bs, new[0])


def paged_decode_attention(q, k_pages, v_pages, block_tables, ctx_lens, *,
                           window=None, cap=None, scale=None, k_scale=None,
                           v_scale=None, local_q=False):
    """Decode attention via block tables. q: (B, 1, H, hd) -> (B, 1, H, hd).
    With tensor parallelism each rank attends its pools' kv heads and the
    heads are gathered (``local_q``: q and the result hold the rank's
    query heads only)."""
    o = over_local_heads(
        lambda qh: ops.paged_attention(
            qh, k_pages, v_pages, block_tables, ctx_lens, window=window,
            cap=cap, scale=scale, k_scale=k_scale, v_scale=v_scale),
        q[:, 0].contiguous(), k_pages.shape[2], local_q)
    return o[:, None].to(q.dtype)


def paged_chunk_attention(q, k_pages, v_pages, block_tables, ctx_lens,
                          q_lens, *, window=None, cap=None, scale=None,
                          k_scale=None, v_scale=None, local_q=False):
    """Chunked-prefill attention via block tables: the C queries of one
    prompt chunk attend causally to the paged context (this chunk's KV
    already scattered in). q: (B, C, H, hd) -> (B, C, H, hd); sharded
    over kv heads as ``paged_decode_attention``."""
    o = over_local_heads(
        lambda qh: ops.paged_prefill_attention(
            qh, k_pages, v_pages, block_tables, ctx_lens, q_lens,
            window=window, cap=cap, scale=scale, k_scale=k_scale,
            v_scale=v_scale),
        q.contiguous(), k_pages.shape[2], local_q)
    return o.to(q.dtype)


def stitch_paged_partials(os, lses):
    """Combine per-shard partial paged attentions into the global result.

    os: (S, ..., hd) locally normalized fp32 outputs; lses: (S, ...)
    their fp32 log-sum-exps, one entry per shard along axis 0. Each
    partial is renormalized by its share of the global softmax mass (the
    flash-decode stitch). Rows no shard attended (every lse <= -1e30)
    come out zero."""
    m = lses.amax(dim=0)
    w = torch.exp(lses - m[None])
    den = torch.clamp(w.sum(dim=0), min=1e-37)
    return (os * w[..., None]).sum(dim=0) / den[..., None]


def paged_shard_attention(q, k_pages, v_pages, block_tables, ctx_lens,
                          n_shards, *, window=None, cap=None, scale=None,
                          k_scale=None, v_scale=None):
    """Pool-sharded paged decode attention: blocks-axis sharding and the
    LSE stitch. Shard s holds the pages of table entries ``j % n_shards ==
    s`` (a round-robin stand-in for ownership by residence), runs the
    partial-softmax kernel over its entries (``ops.paged_attention_partial``:
    the other entries' pages are never read), and the fp32 partials are
    stitched. The same math as ``paged_decode_attention`` for any
    n_shards. q: (B, H, hd) -> (B, H, hd)."""
    if n_shards < 1:
        raise ValueError(f"n_shards={n_shards} must be >= 1")
    B, nb = block_tables.shape
    entry = torch.arange(nb, device=block_tables.device)[None, :]
    parts = [ops.paged_attention_partial(
        q, k_pages, v_pages, block_tables, ctx_lens,
        (entry % n_shards == s).expand(B, nb).to(torch.int32).contiguous(),
        window=window, cap=cap, scale=scale, k_scale=k_scale,
        v_scale=v_scale) for s in range(n_shards)]
    o = stitch_paged_partials(torch.stack([p[0] for p in parts]),
                              torch.stack([p[1] for p in parts]))
    return o.to(q.dtype)


def _gather_dequant(pages, scale, bt):
    """Densify a pool through (B, nb) block tables -> (B, nb*bs, K, hd);
    a quantized pool dequantizes right after the gather."""
    B, K, hd = bt.shape[0], pages.shape[2], pages.shape[3]
    g = quant.take_rows(pages, bt).reshape(B, -1, K, hd)
    if scale is not None:
        g = quant.dequantize_kv(g, scale[bt].reshape(B, -1, K, 1))
    return g


def paged_chunk_attention_xla(q, k_pages, v_pages, block_tables, ctx_lens,
                              q_lens, *, window=None, cap=None, scale=None,
                              k_scale=None, v_scale=None):
    """Plain chunked-prefill path (the JAX package's XLA path, op for op):
    densify the block-table gather (dequantizing a quantized pool), fp32
    logits, softmax normalized in fp32 and cast to the value dtype, then
    p @ v. Padding rows (i >= q_lens) emit garbage; their KV went to the
    trash block and the engine discards their logits."""
    B, C, H, hd = q.shape
    K = k_pages.shape[2]
    G = H // K
    scale = hd ** -0.5 if scale is None else scale
    bt = block_tables.long()
    k = _gather_dequant(k_pages, k_scale, bt)
    v = _gather_dequant(v_pages, v_scale, bt)
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


def ragged_chunk_attention_xla(q, k_pages, v_pages, block_tables, ctx_lens,
                               starts, ends, row_seq, *, window=None,
                               cap=None, scale=None, k_scale=None,
                               v_scale=None):
    """Plain packed (ragged) chunked-prefill path. q: (T, H, hd) flat
    packed rows (layout as in ``update_paged_cache_ragged``). Gathers each
    packed sequence's rows into the dense (S, T, H, hd) layout, runs
    ``paged_chunk_attention_xla`` (the single-chunk path, S batch rows
    instead of 1) and scatters the rows back flat. The gather and scatter
    are exact copies, so each row matches the single-chunk path; rows
    owned by no sequence come back zero."""
    T = q.shape[0]
    t = torch.arange(T, device=q.device)
    st, en, rs = starts.long(), ends.long(), row_seq.long()
    gidx = (st[:, None] + t[None]).clamp(0, T - 1)               # (S, T)
    od = paged_chunk_attention_xla(
        q[gidx], k_pages, v_pages, block_tables, ctx_lens, ends - starts,
        window=window, cap=cap, scale=scale, k_scale=k_scale,
        v_scale=v_scale)                                     # (S, T, H, hd)
    o = od[rs, (t - st[rs]).clamp(0, T - 1)]                     # (T, H, hd)
    valid = (t >= st[rs]) & (t < en[rs])
    return torch.where(valid[:, None, None], o, 0).to(q.dtype)


def ragged_chunk_attention(q, k_pages, v_pages, block_tables, ctx_lens,
                           starts, ends, row_seq, *, window=None, cap=None,
                           scale=None, k_scale=None, v_scale=None,
                           local_q=False):
    """Packed (ragged) chunked-prefill attention via block tables: chunks
    of up to S sequences ride one flat (1, T, H, hd) row batch, each row
    attending causally to its owner's paged context (the chunk's KV
    already scattered in). Returns (1, T, H, hd); sharded over kv heads as
    ``paged_decode_attention``."""
    o = over_local_heads(
        lambda qh: ops.ragged_paged_prefill_attention(
            qh, k_pages, v_pages, block_tables, ctx_lens, starts, ends,
            row_seq, window=window, cap=cap, scale=scale, k_scale=k_scale,
            v_scale=v_scale),
        q[0].contiguous(), k_pages.shape[2], local_q)
    return o[None].to(q.dtype)


def ragged_chunk_update_attend(q, k_new, v_new, k_pages, v_pages,
                               block_tables, ctx_lens, starts, ends,
                               row_seq, *, window=None, cap=None,
                               scale=None, k_scale=None, v_scale=None,
                               local_q=False):
    """Scatter a packed chunk's KV into the pages and attend, as one fused
    op (``ops.ragged_prefill_update_attend``). q: (1, T, H, hd); k_new /
    v_new: (1, T, K, hd), same flat rows. Returns ``(o, k_pages,
    v_pages)``, the pools updated in place.

    Quantized pools (``k_scale``/``v_scale`` given): the chunk's K/V is
    quantized here and its scale rows are scattered into the scale pools
    before the fused op, which reads them for the dequant. Returns
    ``(o, k_pages, v_pages, k_scale, v_scale)``.

    With tensor parallelism k_new / v_new are cut to this rank's kv heads
    (the pools' heads) and the attention is sharded as
    ``paged_decode_attention``'s."""
    K_l = k_pages.shape[2]
    k_new, v_new = local_kv_heads(k_new, K_l), local_kv_heads(v_new, K_l)
    if k_scale is not None:
        kvd = quant.kv_dtype_name(k_pages.dtype)
        k_new, ksr = quant.quantize_kv(k_new, kvd)
        v_new, vsr = quant.quantize_kv(v_new, kvd)
        for pool, rows in ((k_scale, ksr), (v_scale, vsr)):
            update_paged_cache_ragged(pool, rows, block_tables, ctx_lens,
                                      starts, ends, row_seq)
    o = over_local_heads(
        lambda qh: ops.ragged_prefill_update_attend(
            qh, k_new[0].contiguous(), v_new[0].contiguous(), k_pages,
            v_pages, block_tables, ctx_lens, starts, ends, row_seq,
            window=window, cap=cap, scale=scale, k_scale=k_scale,
            v_scale=v_scale)[0],
        q[0].contiguous(), K_l, local_q)
    kc, vc = k_pages, v_pages
    if k_scale is not None:
        return o[None].to(q.dtype), kc, vc, k_scale, v_scale
    return o[None].to(q.dtype), kc, vc

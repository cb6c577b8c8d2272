"""Kernel entry points, dispatched by the device of the tensors alone.

A CUDA tensor goes to the hand-written kernel, which launches or raises;
nothing falls back. A CPU tensor goes to the plain PyTorch version, which
is what the JAX package's ops run off the TPU (``repro.kernels.ops``):
``ref.paged_attention_ref`` for decode (``ref.paged_attention_partial_ref``
for its fp32 partials), ``paged_chunk_attention_xla`` for chunked prefill
(``ref.paged_prefill_attention_partial_ref`` for its partials), ``ragged_chunk_attention_xla`` for packed prefill (after
``update_paged_cache_ragged`` for the fused write), ``table[ids]`` for the
gather, ``models.ssm.ssd_chunked`` for the SSD scan,
``models.attention.dense_attention`` for flash attention (up to
``DENSE_ATTN_MAX_KV`` keys, the streaming ``block_causal_attention`` /
``chunked_attention`` beyond, as off the TPU), ``ref.sampled_softmax_loss_ref``
for the sampled-softmax loss. There is no switch
between the two other than where the tensors live. ``k_scale``/``v_scale``
mark int8/fp8 pools, dequantized in-tile by the kernels and after the
gather by the plain versions.
"""

from __future__ import annotations

from repro_torch.kernels import embedding as emb
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref
from repro_torch.kernels import sampled_softmax as ss
from repro_torch.kernels import ssd as ssd_k

# The JAX package's plain path runs dense attention, one (Sq, Skv) logit
# block per head, up to this many keys, and streaming forms beyond it.
DENSE_ATTN_MAX_KV = 8192


def flash_attention(q, k, v, *, causal=True, window=None, cap=None,
                    scale=None, q_offset=0):
    """Full-sequence attention, q (B, Sq, H, hd), k/v (B, Skv, K, hd),
    differentiable. On the card: the flash kernel forward under
    ``FlashAttention`` (plain recompute backward). On the CPU, under
    autograd: ``dense_attention`` up to ``DENSE_ATTN_MAX_KV`` keys, beyond
    them ``block_causal_attention`` for causal self attention and
    ``chunked_attention`` otherwise, over 1024-key chunks."""
    if q.is_cuda:
        return fa.FlashAttention.apply(q.contiguous(), k.contiguous(),
                                       v.contiguous(), causal, window, cap,
                                       scale, q_offset)
    from repro_torch.models.attention import (block_causal_attention,
                                              chunked_attention,
                                              dense_attention)
    kw = dict(window=window, cap=cap, scale=scale)
    if k.shape[1] <= DENSE_ATTN_MAX_KV:
        return dense_attention(q, k, v, causal=causal, q_offset=q_offset,
                               **kw)
    if causal and q_offset == 0 and q.shape[1] == k.shape[1]:
        return block_causal_attention(q, k, v, **kw)
    return chunked_attention(q, k, v, causal=causal, q_offset=q_offset,
                             **kw)


def paged_attention(q, k_pages, v_pages, block_tables, ctx_lens, *,
                    window=None, cap=None, scale=None, k_scale=None,
                    v_scale=None):
    """Decode attention through a block table. q: (B, H, hd)."""
    fn = pa.paged_attention if q.is_cuda else ref.paged_attention_ref
    return fn(q, k_pages, v_pages, block_tables, ctx_lens, window=window,
              cap=cap, scale=scale, k_scale=k_scale, v_scale=v_scale)


def paged_attention_partial(q, k_pages, v_pages, block_tables, ctx_lens,
                            block_mask, *, window=None, cap=None,
                            scale=None, k_scale=None, v_scale=None):
    """Partial-softmax paged decode over a shard-local block table: only
    the table entries ``block_mask`` (B, nb) selects are attended.
    Returns fp32 ``(o, lse)``, o (B, H, hd), lse (B, H), for the
    cross-shard LSE stitch (``models.attention.stitch_paged_partials``)."""
    kw = dict(window=window, cap=cap, scale=scale, k_scale=k_scale,
              v_scale=v_scale)
    if q.is_cuda:
        return pa.paged_attention(q, k_pages, v_pages, block_tables,
                                  ctx_lens, block_mask=block_mask,
                                  return_lse=True, **kw)
    return ref.paged_attention_partial_ref(q, k_pages, v_pages, block_tables,
                                           ctx_lens, block_mask, **kw)


def paged_prefill_attention_partial(q, k_pages, v_pages, block_tables,
                                    ctx_lens, q_lens, block_mask, *,
                                    window=None, cap=None, scale=None,
                                    k_scale=None, v_scale=None):
    """The chunk kernel's partials (``paged_prefill_attention`` with
    ``block_mask`` and ``return_lse``): fp32 ``(o, lse)``, o (B, C, H,
    hd), lse (B, C, H)."""
    kw = dict(window=window, cap=cap, scale=scale, k_scale=k_scale,
              v_scale=v_scale)
    if q.is_cuda:
        return pa.paged_prefill_attention(
            q, k_pages, v_pages, block_tables, ctx_lens, q_lens,
            block_mask=block_mask, return_lse=True, **kw)
    return ref.paged_prefill_attention_partial_ref(
        q, k_pages, v_pages, block_tables, ctx_lens, q_lens, block_mask,
        **kw)


def paged_prefill_attention(q, k_pages, v_pages, block_tables, ctx_lens,
                            q_lens, *, window=None, cap=None, scale=None,
                            k_scale=None, v_scale=None):
    """Chunked-prefill attention through a block table. q: (B, C, H, hd)."""
    if q.is_cuda:
        fn = pa.paged_prefill_attention
    else:
        from repro_torch.models.attention import \
            paged_chunk_attention_xla as fn
    return fn(q, k_pages, v_pages, block_tables, ctx_lens, q_lens,
              window=window, cap=cap, scale=scale, k_scale=k_scale,
              v_scale=v_scale)


def ragged_paged_prefill_attention(q, k_pages, v_pages, block_tables,
                                   ctx_lens, starts, ends, row_seq, *,
                                   window=None, cap=None, scale=None,
                                   k_scale=None, v_scale=None):
    """Packed (ragged) chunked-prefill attention through per-sequence
    block tables: q (T, H, hd), sequence s owning flat rows [starts[s],
    ends[s]), row_seq each row's owner. The chunk's own KV must already
    be in the pages."""
    kw = dict(window=window, cap=cap, scale=scale, k_scale=k_scale,
              v_scale=v_scale)
    if q.is_cuda:
        return pa.ragged_paged_prefill_attention(
            q, k_pages, v_pages, block_tables, ctx_lens, starts, ends, **kw)
    from repro_torch.models.attention import ragged_chunk_attention_xla
    return ragged_chunk_attention_xla(q, k_pages, v_pages, block_tables,
                                      ctx_lens, starts, ends, row_seq, **kw)


def ragged_prefill_update_attend(q, k_new, v_new, k_pages, v_pages,
                                 block_tables, ctx_lens, starts, ends,
                                 row_seq, *, window=None, cap=None,
                                 scale=None, k_scale=None, v_scale=None):
    """Packed-prefill KV store and attention in one op: k_new / v_new
    (T, K, hd) in the flat row layout of q, already quantized for an
    int8/fp8 pool whose scale pools already hold the chunk's scale rows.
    Returns ``(o, k_pages, v_pages)``, the pools updated in place: by the
    kernel's fused write on the card, by ``update_paged_cache_ragged``
    before the attention on the CPU (the same pool bytes)."""
    kw = dict(window=window, cap=cap, scale=scale, k_scale=k_scale,
              v_scale=v_scale)
    if q.is_cuda:
        return pa.ragged_paged_prefill_attention(
            q, k_pages, v_pages, block_tables, ctx_lens, starts, ends,
            k_new=k_new, v_new=v_new, **kw)
    from repro_torch.models.attention import (ragged_chunk_attention_xla,
                                              update_paged_cache_ragged)
    for pool, new in ((k_pages, k_new), (v_pages, v_new)):
        update_paged_cache_ragged(pool, new[None], block_tables, ctx_lens,
                                  starts, ends, row_seq)
    o = ragged_chunk_attention_xla(q, k_pages, v_pages, block_tables,
                                   ctx_lens, starts, ends, row_seq, **kw)
    return o, k_pages, v_pages


def embedding_gather(table, ids):
    """``table[ids]``, differentiable in the table."""
    if table.is_cuda:
        return emb.Gather.apply(table, ids)
    return emb.gather_plain(table, ids)


def sampled_softmax_loss(x, table, labels, sampled_ids, *, cap=None):
    """Mean sampled-softmax loss, x (T, d), table (V, d), labels (T,),
    sampled_ids (n,). Forward only on the card, as the Pallas kernel."""
    if x.is_cuda:
        return ss.sampled_softmax_loss(x, table, labels, sampled_ids,
                                       cap=cap)
    return ref.sampled_softmax_loss_ref(x, table, labels, sampled_ids,
                                        cap=cap)


def ssd(x, dt, A, B, C, *, chunk, h0=None):
    """Chunked SSD scan: x (b, S, nh, hp), dt (b, S, nh) fp32, A (nh,),
    B, C (b, S, G, N), h0 (b, nh, hp, N) fp32 or None. Returns (y, h_last),
    differentiable: on the card the kernel under ``SSD`` (plain recompute
    backward), on the CPU ``ssd_chunked`` under autograd. B and C go to the
    kernel as they come, slices of the conv output (it
    takes their row strides); the other CUDA operands are made contiguous
    (they already are on the model path)."""
    if x.is_cuda:
        x, dt, A = (t.contiguous() for t in (x, dt, A))
        return ssd_k.SSD.apply(x, dt, A, B, C,
                               None if h0 is None else h0.contiguous(), chunk)
    from repro_torch.models.ssm import ssd_chunked
    return ssd_chunked(x, dt, A, B, C, chunk=chunk, h0=h0)

"""Kernel entry points, dispatched by the device of the tensors alone.

A CUDA tensor goes to the hand-written kernel, which launches or raises;
nothing falls back. A CPU tensor goes to the plain PyTorch version, which
is what the JAX package's ops run off the TPU (``repro.kernels.ops``):
``ref.paged_attention_ref`` for decode, ``paged_chunk_attention_xla`` for
chunked prefill, ``table[ids]`` for the gather. There is no switch
between the two other than where the tensors live.
"""

from __future__ import annotations

from repro_torch.kernels import embedding as emb
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref


def paged_attention(q, k_pages, v_pages, block_tables, ctx_lens, *,
                    window=None, cap=None, scale=None):
    """Decode attention through a block table. q: (B, H, hd)."""
    if q.is_cuda:
        return pa.paged_attention(q, k_pages, v_pages, block_tables,
                                  ctx_lens, window=window, cap=cap,
                                  scale=scale)
    return ref.paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   ctx_lens, window=window, cap=cap,
                                   scale=scale)


def paged_prefill_attention(q, k_pages, v_pages, block_tables, ctx_lens,
                            q_lens, *, window=None, cap=None, scale=None):
    """Chunked-prefill attention through a block table. q: (B, C, H, hd)."""
    if q.is_cuda:
        return pa.paged_prefill_attention(q, k_pages, v_pages, block_tables,
                                          ctx_lens, q_lens, window=window,
                                          cap=cap, scale=scale)
    from repro_torch.models.attention import paged_chunk_attention_xla
    return paged_chunk_attention_xla(q, k_pages, v_pages, block_tables,
                                     ctx_lens, q_lens, window=window,
                                     cap=cap, scale=scale)


def embedding_gather(table, ids):
    if table.is_cuda:
        return emb.gather(table, ids)
    return emb.gather_plain(table, ids)

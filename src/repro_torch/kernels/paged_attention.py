"""Paged attention (decode and chunked prefill): the hand-written CUDA
kernels, ported from the Pallas TPU kernels ``paged_attention`` and
``paged_prefill_attention`` in ``repro.kernels.paged_attention``.

Both wrappers launch ``csrc/paged_attention.cu``, which follows the
Pallas schedule: one program per (sequence, kv head) walking the block
table in order with an fp32 online softmax, the masked-row guard, and a
divide by the running sum at the end. The plain versions of the same
functions are ``kernels.ref.paged_attention_ref`` (decode) and
``models.attention.paged_chunk_attention_xla`` (chunk); they follow the
repo's rounding convention instead (normalize, cast, then multiply by V),
so kernel and plain agree to the bf16 tolerance, not bit for bit.

Layouts are the JAX package's: q (B, H, hd) or (B, C, H, hd), page pools
(num_blocks, block_size, K, hd), block tables (B, nb) int32, ctx_lens and
q_lens (B,) int32. The kernels take bf16 only, block_size up to 32 and
head_dim 128 (glm4_9b) or 16 (its smoke size).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

MAX_BLOCK_SIZE = 32
HEAD_DIMS = (16, 128)


def refuse_unported(pages_per_compute_block, block_mask, return_lse,
                    k_scale, v_scale):
    """Raise for the kernel options this slice does not port."""
    if block_mask is not None or return_lse:
        raise NotImplementedError(
            "block_mask / return_lse partials are not ported yet "
            "(ROADMAP.md, Next item 2)")
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "quantized pools (fused int8/fp8 dequant) are not ported yet "
            "(ROADMAP.md, Next item 2)")
    if pages_per_compute_block not in (None, 1):
        raise NotImplementedError(
            f"pages_per_compute_block={pages_per_compute_block}: P > 1 is "
            "not ported yet (ROADMAP.md, Next item 2)")


def _check(q, k_pages, v_pages, block_tables, ctx_lens, q_lens=None):
    """Raise on anything the CUDA kernel does not take."""
    dev = q.device
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("ctx_lens", ctx_lens),
                    ("q_lens", q_lens)):
        if t is None:
            continue
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name} must be on {dev} (a CUDA device), got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        want = torch.bfloat16 if "pages" in name or name == "q" \
            else torch.int32
        if t.dtype != want:
            raise ValueError(f"{name} must be {want}, got {t.dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    _, bs, K, hd = k_pages.shape
    if v_pages.shape != k_pages.shape:
        raise ValueError(f"k/v pools differ: {tuple(k_pages.shape)} vs "
                         f"{tuple(v_pages.shape)}")
    if hd not in HEAD_DIMS or bs > MAX_BLOCK_SIZE:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS} or block_size "
                         f"{bs} > {MAX_BLOCK_SIZE}")
    H = q.shape[-2]
    if q.shape[-1] != hd or H % K:
        raise ValueError(f"q {tuple(q.shape)} does not fit pools with K={K}, "
                         f"hd={hd}")
    B = q.shape[0]
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or ctx_lens.shape != (B,) \
            or (q_lens is not None and q_lens.shape != (B,)):
        raise ValueError("block_tables (B, nb), ctx_lens (B,) and q_lens "
                         f"(B,) must match q's batch {B}")


def _lib():
    lib = build.load("paged_attention")
    common = [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_float,
                                   ctypes.c_int, ctypes.c_void_p]
    lib.paged_decode.argtypes = [ctypes.c_void_p] * 6 + common
    lib.paged_decode.restype = ctypes.c_int
    lib.paged_prefill.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] \
        + common
    lib.paged_prefill.restype = ctypes.c_int
    return lib


def _knobs(hd, window, cap, scale):
    scale = hd ** -0.5 if scale is None else float(scale)
    return (scale, 0.0 if cap is None else float(cap),
            0 if window is None else int(window))


def paged_attention(q, k_pages, v_pages, block_tables, ctx_lens, *,
                    window=None, cap=None, scale=None, block_mask=None,
                    return_lse=False, pages_per_compute_block=1,
                    k_scale=None, v_scale=None):
    """Decode: q (B, H, hd), one query per sequence -> (B, H, hd) bf16.
    ctx_lens == 0 marks an inactive slot, whose output row is zeros."""
    refuse_unported(pages_per_compute_block, block_mask, return_lse,
                    k_scale, v_scale)
    _check(q, k_pages, v_pages, block_tables, ctx_lens)
    B, H, hd = q.shape
    _, bs, K, _ = k_pages.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _lib().paged_decode(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), ctx_lens.data_ptr(), out.data_ptr(),
            B, H, K, hd, bs, block_tables.shape[1],
            *_knobs(hd, window, cap, scale), build.current_stream(q))
    if rc != 0:
        raise RuntimeError(f"paged_decode launch failed: cudaError {rc}")
    paged_attention.launches += 1
    return out


def paged_prefill_attention(q, k_pages, v_pages, block_tables, ctx_lens,
                            q_lens, *, window=None, cap=None, scale=None,
                            block_mask=None, return_lse=False,
                            pages_per_compute_block=1, k_scale=None,
                            v_scale=None):
    """Chunked prefill: q (B, C, H, hd); row i of sequence b sits at
    absolute position ``ctx_lens[b] - q_lens[b] + i`` (the chunk's KV is
    already in the pages). Rows at or past q_lens are zeros.
    Returns (B, C, H, hd) bf16."""
    refuse_unported(pages_per_compute_block, block_mask, return_lse,
                    k_scale, v_scale)
    _check(q, k_pages, v_pages, block_tables, ctx_lens, q_lens)
    B, C, H, hd = q.shape
    _, bs, K, _ = k_pages.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _lib().paged_prefill(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), ctx_lens.data_ptr(), q_lens.data_ptr(),
            out.data_ptr(), B, C, H, K, hd, bs, block_tables.shape[1],
            *_knobs(hd, window, cap, scale), build.current_stream(q))
    if rc != 0:
        raise RuntimeError(f"paged_prefill launch failed: cudaError {rc}")
    paged_prefill_attention.launches += 1
    return out


paged_attention.launches = 0
paged_prefill_attention.launches = 0

"""Paged attention (decode, chunked prefill and packed ragged prefill): the
hand-written CUDA kernels, ported from the Pallas TPU kernels
``paged_attention``, ``paged_prefill_attention`` and
``ragged_paged_prefill_attention`` in ``repro.kernels.paged_attention``.

The wrappers launch ``csrc/paged_attention.cu`` (decode, chunk) and
``csrc/ragged_paged_attention.cu`` (packed, optionally with the fused KV
write), one templated kernel (``csrc/paged_attention.cuh``) on the tensor
cores: 64-key steps at absolute positions with an fp32 online softmax and
the masked-row guard, partial states per 256-key segment merged in
segment order, and a divide by the running sum at the end. Decode runs
the segments in parallel blocks and merges them in a second launch,
through an fp32 scratch tensor the wrapper allocates. The plain versions
of the same functions are ``kernels.ref.paged_attention_ref`` (decode),
``models.attention.paged_chunk_attention_xla`` (chunk) and
``models.attention.ragged_chunk_attention_xla`` (packed; with
``update_paged_cache_ragged`` before it for the fused write). They follow
the repo's rounding convention instead (normalize, cast, then multiply by
V), so kernel and plain agree to the bf16 tolerance, not bit for bit.
Between the kernels a row's bits depend only on its own query and keys:
a 1-row chunk equals a decode step, and a packed sequence equals its
unpacked chunk.

Layouts are the JAX package's: q (B, H, hd), (B, C, H, hd) or flat
(T, H, hd); page pools (num_blocks, block_size, K, hd) in bf16, int8 or
fp8 e4m3; for int8/fp8 pools, fp32 scale pools (num_blocks, block_size,
K, 1), dequantized in-tile; block tables (n_seqs, nb) int32; ctx_lens,
q_lens, starts and ends (n_seqs,) int32. The kernels take bf16 queries,
block_size up to 32 and head_dim 128 (glm4_9b and the other decoders),
80 (zamba2_2p7b's shared attention), 64 (whisper_large_v3's decoder) or
16 (the smoke sizes).

The decode and chunk wrappers also take the TPU kernels' options of
pool-sharded serving: ``block_mask`` (n_seqs, nb), whose zero entries'
pages are neither read nor attended, and ``return_lse``, which returns
fp32 partials ``(o, lse)`` for the LSE stitch
(``models.attention.stitch_paged_partials``): o the locally normalized
output, lse (B, H) or (B, C, H) the log-sum-exp of the attended keys,
<= -1e30 where a row attended nothing. The arithmetic is the same as
without them: with a full mask, o rounded to bf16 is the plain launch's
output byte for byte. ``pages_per_compute_block``, the TPU kernels' grid
knob, is accepted and ignored (any P gives the same math there too). The
packed kernel has no partials, in the JAX package either.

Each wrapper counts its launches by pool dtype name in ``.launches``; a
partial launch counts under "partial" (bf16 pools) or "<pool>_partial".
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from repro_torch.kernels import build
from repro_torch.models.quant import kv_dtype_name

MAX_BLOCK_SIZE = 32
HEAD_DIMS = (16, 64, 80, 128)
POOL_CODES = {"bf16": 0, "int8": 1, "fp8": 2}   # csrc's PoolType
_VP, _INT, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _refuse_ragged_partials(block_mask, return_lse):
    """The packed kernel has no partials: the JAX package's has none."""
    if block_mask is not None or return_lse:
        raise NotImplementedError(
            "block_mask / return_lse: the packed (ragged) kernel has no "
            "partials, in the JAX package either (ROADMAP.md queue 2 item "
            "3)")


def _partial_io(q, block_mask, return_lse, n_seqs, nb):
    """(block mask int32 or None, out, lse or None) of a decode or chunk
    launch: fp32 o and its lse for a partial, else a bf16 out like q."""
    if block_mask is not None:
        if tuple(block_mask.shape) != (n_seqs, nb):
            raise ValueError(f"block_mask must be ({n_seqs}, {nb}), got "
                             f"{tuple(block_mask.shape)}")
        if block_mask.device != q.device:
            raise ValueError(f"block_mask must be on {q.device}, got "
                             f"{block_mask.device}")
        block_mask = block_mask.to(torch.int32).contiguous()
    if not return_lse:
        return block_mask, torch.empty_like(q), None
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    return block_mask, out, lse


def launch_key(pool: str, partial: bool) -> str:
    """A launch's counter key: the pool's name, or for a launch of the
    partials' instantiation (a block mask or an lse) "partial" (bf16) or
    "<pool>_partial"."""
    if not partial:
        return pool
    return "partial" if pool == "bf16" else f"{pool}_partial"


def _check(q, k_pages, v_pages, k_scale, v_scale, block_tables, n_seqs,
           **meta):
    """Raise ValueError on anything the CUDA kernel does not take. Shapes
    and dtypes are checked before devices, so a malformed call says what
    is malformed on any device. Returns the pool dtype's name."""
    try:
        pool = kv_dtype_name(k_pages.dtype)
    except ValueError as e:
        raise ValueError(f"k_pages: {e}") from None
    if v_pages.dtype != k_pages.dtype or v_pages.shape != k_pages.shape:
        raise ValueError(f"k/v pools differ: {k_pages.dtype} "
                         f"{tuple(k_pages.shape)} vs {v_pages.dtype} "
                         f"{tuple(v_pages.shape)}")
    if k_pages.dim() != 4:
        raise ValueError(f"pools must be (num_blocks, block_size, K, hd), "
                         f"got {tuple(k_pages.shape)}")
    _, bs, K, hd = k_pages.shape
    if hd not in HEAD_DIMS or bs > MAX_BLOCK_SIZE:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS} or block_size "
                         f"{bs} > {MAX_BLOCK_SIZE}")
    if q.dtype != torch.bfloat16 or q.shape[-1] != hd or q.shape[-2] % K:
        raise ValueError(f"q {q.dtype} {tuple(q.shape)} does not fit bf16 "
                         f"queries for pools with K={K}, hd={hd}")
    want_scale = tuple(k_pages.shape[:3]) + (1,)
    for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
        if pool == "bf16":
            if s is not None:
                raise ValueError(f"{name} given for a bf16 pool")
        elif s is None or s.dtype != torch.float32 \
                or tuple(s.shape) != want_scale:
            got = None if s is None else f"{s.dtype} {tuple(s.shape)}"
            raise ValueError(f"{name} of a {pool} pool must be float32 "
                             f"{want_scale}, got {got}")
    if block_tables.dim() != 2 or block_tables.shape[0] != n_seqs:
        raise ValueError(f"block_tables must be ({n_seqs}, nb), got "
                         f"{tuple(block_tables.shape)}")
    for name, t in meta.items():
        if t is not None and tuple(t.shape) != (n_seqs,):
            raise ValueError(f"{name} must be ({n_seqs},), got "
                             f"{tuple(t.shape)}")
    dev = q.device
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               "k_scale": k_scale, "v_scale": v_scale,
               "block_tables": block_tables, **meta}
    for name, t in tensors.items():
        if t is None:
            continue
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name} must be on {dev} (a CUDA device), got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if (name in meta or name == "block_tables") \
                and t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
        if name in ("q", "k_pages", "v_pages") and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             "reads it in 16-byte vectors)")
    return pool


def _lib(stem):
    lib = build.load(stem)
    knobs = [_INT, _F, _F, _INT, _VP]      # pool_type, scale, cap, window,
    if stem == "paged_attention":           # stream
        lib.paged_decode.argtypes = [_VP] * 11 + [ctypes.c_longlong] \
            + [_INT] * 6 + knobs
        lib.paged_decode.restype = _INT
        lib.paged_decode_scratch_floats.argtypes = [_INT] * 6
        lib.paged_decode_scratch_floats.restype = ctypes.c_longlong
        lib.paged_prefill.argtypes = [_VP] * 11 + [_INT] * 7 + knobs
        lib.paged_prefill.restype = _INT
    else:
        lib.ragged_paged_prefill.argtypes = [_VP] * 12 + [_INT] * 7 + knobs
        lib.ragged_paged_prefill.restype = _INT
    return lib


def _knobs(pool, hd, window, cap, scale):
    scale = hd ** -0.5 if scale is None else float(scale)
    return (POOL_CODES[pool], scale, 0.0 if cap is None else float(cap),
            0 if window is None else int(window))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


def paged_attention(q, k_pages, v_pages, block_tables, ctx_lens, *,
                    window=None, cap=None, scale=None, block_mask=None,
                    return_lse=False, pages_per_compute_block=1,
                    k_scale=None, v_scale=None):
    """Decode: q (B, H, hd), one query per sequence -> (B, H, hd) bf16.
    ctx_lens == 0 marks an inactive slot, whose output row is zeros. With
    ``return_lse``: fp32 ``(o, lse)``, lse (B, H); ``block_mask`` (B, nb)
    leaves out the pages of its zero entries."""
    B, H, hd = q.shape
    pool = _check(q, k_pages, v_pages, k_scale, v_scale, block_tables, B,
                  ctx_lens=ctx_lens)
    _, bs, K, _ = k_pages.shape
    nb = block_tables.shape[1]
    lib = _lib("paged_attention")
    mask, out, lse = _partial_io(q, block_mask, return_lse, B, nb)
    # the segments' partial states (csrc/paged_attention.cu says the size)
    part = torch.empty(lib.paged_decode_scratch_floats(B, H, K, hd, bs, nb),
                       dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.paged_decode(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            _ptr(k_scale), _ptr(v_scale), block_tables.data_ptr(),
            ctx_lens.data_ptr(), _ptr(mask), out.data_ptr(), _ptr(lse),
            part.data_ptr(), part.numel(), B, H, K, hd, bs, nb,
            *_knobs(pool, hd, window, cap, scale), build.current_stream(q))
    _raise_on(rc, "paged_decode")
    paged_attention.launches[
        launch_key(pool, mask is not None or return_lse)] += 1
    return (out, lse) if return_lse else out


def paged_prefill_attention(q, k_pages, v_pages, block_tables, ctx_lens,
                            q_lens, *, window=None, cap=None, scale=None,
                            block_mask=None, return_lse=False,
                            pages_per_compute_block=1, k_scale=None,
                            v_scale=None):
    """Chunked prefill: q (B, C, H, hd); row i of sequence b sits at
    absolute position ``ctx_lens[b] - q_lens[b] + i`` (the chunk's KV is
    already in the pages). Rows at or past q_lens are zeros.
    Returns (B, C, H, hd) bf16, or with ``return_lse`` fp32 ``(o, lse)``,
    lse (B, C, H); ``block_mask`` as in ``paged_attention``."""
    B, C, H, hd = q.shape
    pool = _check(q, k_pages, v_pages, k_scale, v_scale, block_tables, B,
                  ctx_lens=ctx_lens, q_lens=q_lens)
    _, bs, K, _ = k_pages.shape
    nb = block_tables.shape[1]
    mask, out, lse = _partial_io(q, block_mask, return_lse, B, nb)
    with torch.cuda.device(q.device):
        rc = _lib("paged_attention").paged_prefill(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            _ptr(k_scale), _ptr(v_scale), block_tables.data_ptr(),
            ctx_lens.data_ptr(), q_lens.data_ptr(), _ptr(mask),
            out.data_ptr(), _ptr(lse), B, C, H, K, hd, bs, nb,
            *_knobs(pool, hd, window, cap, scale), build.current_stream(q))
    _raise_on(rc, "paged_prefill")
    paged_prefill_attention.launches[
        launch_key(pool, mask is not None or return_lse)] += 1
    return (out, lse) if return_lse else out


def ragged_paged_prefill_attention(q, k_pages, v_pages, block_tables,
                                   ctx_lens, starts, ends, *, k_new=None,
                                   v_new=None, window=None, cap=None,
                                   scale=None, block_mask=None,
                                   return_lse=False,
                                   pages_per_compute_block=1, k_scale=None,
                                   v_scale=None):
    """Packed (ragged) chunked prefill: q (T, H, hd), the chunks of S
    sequences back to back; sequence s owns flat rows [starts[s],
    ends[s]) and its row i sits at absolute position ``ctx_lens[s] -
    (ends[s] - starts[s]) + i`` (``starts == ends``: an unused pack slot).
    Rows no sequence owns are zeros. Returns (T, H, hd) bf16.

    With ``k_new``/``v_new`` ((T, K, hd) in the pool dtype, already
    quantized for an int8/fp8 pool, whose chunk scale rows must already be
    in the scale pools) the chunk's KV is also stored into the pages, in
    place, and ``(o, k_pages, v_pages)`` is returned."""
    _refuse_ragged_partials(block_mask, return_lse)
    if (k_new is None) != (v_new is None):
        raise ValueError("k_new and v_new must be given together")
    T, H, hd = q.shape
    S = starts.shape[0]
    pool = _check(q, k_pages, v_pages, k_scale, v_scale, block_tables, S,
                  ctx_lens=ctx_lens, starts=starts, ends=ends)
    _, bs, K, _ = k_pages.shape
    if k_new is not None:
        for name, t in (("k_new", k_new), ("v_new", v_new)):
            if t.dtype != k_pages.dtype or tuple(t.shape) != (T, K, hd):
                raise ValueError(f"{name} must be {k_pages.dtype} "
                                 f"{(T, K, hd)}, got {t.dtype} "
                                 f"{tuple(t.shape)}")
            if t.device != q.device or not t.is_contiguous() \
                    or t.data_ptr() % 16:
                raise ValueError(f"{name} must be contiguous, 16-byte "
                                 f"aligned and on {q.device}")
    out = torch.zeros_like(q)         # rows no sequence owns stay zero
    with torch.cuda.device(q.device):
        rc = _lib("ragged_paged_attention").ragged_paged_prefill(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            _ptr(k_scale), _ptr(v_scale), _ptr(k_new), _ptr(v_new),
            block_tables.data_ptr(), ctx_lens.data_ptr(), starts.data_ptr(),
            ends.data_ptr(), out.data_ptr(), T, S, H, K, hd, bs,
            block_tables.shape[1], *_knobs(pool, hd, window, cap, scale),
            build.current_stream(q))
    _raise_on(rc, "ragged_paged_prefill")
    ragged_paged_prefill_attention.launches[pool] += 1
    if k_new is None:
        return out
    return out, k_pages, v_pages


paged_attention.launches = Counter()
paged_prefill_attention.launches = Counter()
ragged_paged_prefill_attention.launches = Counter()

"""Flash attention: the hand-written CUDA forward, its wrapper and the
autograd function that training runs.

Port of ``repro.kernels.flash_attention.flash_attention`` (a Pallas TPU
forward kernel under a ``jax.custom_vjp`` whose backward ``_bwd_ref`` is
plain jnp). The kernel is ``csrc/flash_attention.cu``; its plain version
is ``ref.flash_attention_fwd_plain`` (the same (o, lse)). ``FlashAttention``
runs the kernel forward, saves ``(q, k, v, o, lse)`` as ``_vjp_fwd`` does,
and its backward is ``ref.flash_attention_bwd_plain``, the port of
``_bwd_ref``: the JAX package has no backward kernel either. The kernel
has one fixed summation order, so remat's recompute of a layer gives the
forward's bits.

``flash_attention.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

HEAD_DIMS = (16, 128)
_VP, _INT, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib():
    lib = build.load("flash_attention")
    lib.flash_attention_fwd.argtypes = [_VP] * 5 + [_INT] * 6 + [_F, _F] \
        + [_INT] * 3 + [_VP]
    lib.flash_attention_fwd.restype = _INT
    return lib


def _check(q, k, v, window, q_offset):
    """Raise ValueError on what the kernel does not take: shapes, dtypes
    and head dims first, then devices, contiguity and alignment."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q (B, Sq, H, hd) and k, v (B, "
                         f"Skv, K, hd) expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"fit q {tuple(q.shape)} (same B and hd, K "
                         "dividing H)")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise ValueError("flash_attention: the kernel takes bf16 q, k, v, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel takes head dims "
                         f"{HEAD_DIMS}, got {hd}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got "
                         f"{window}")
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset must be >= 0, got "
                         f"{q_offset}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be on "
                             f"{q.device} (a CUDA device), got {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous "
                             "and 16-byte aligned")


def flash_attention(q, k, v, *, causal=True, window=None, cap=None,
                    scale=None, q_offset=0):
    """CUDA flash forward. q (B, Sq, H, hd), k/v (B, Skv, K, hd) bf16
    contiguous on one card, hd 16 or 128; query row i sits at absolute
    position ``q_offset + i``. Returns (o (B, Sq, H, hd) bf16, lse (B, Sq,
    H) fp32)."""
    _check(q, k, v, window, q_offset)
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    o = torch.empty_like(q)
    lse = torch.empty((B, Sq, H), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _lib().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, Sq, Skv, H, K, hd, float(scale),
            0.0 if cap is None else float(cap), int(causal),
            0 if window is None else int(window), int(q_offset),
            build.current_stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError "
                           f"{rc}")
    flash_attention.launches += 1
    return o, lse


flash_attention.launches = 0


class FlashAttention(torch.autograd.Function):
    """o = attention(q, k, v) through the kernel; gradients by the plain
    recompute backward from (q, k, v, o, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, cap, scale, q_offset):
        o, lse = flash_attention(q, k, v, causal=causal, window=window,
                                 cap=cap, scale=scale, q_offset=q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = dict(causal=causal, window=window, cap=cap, scale=scale,
                        q_offset=q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = ref.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                   **ctx.opts)
        return dq, dk, dv, None, None, None, None, None

"""Flash attention: the hand-written CUDA forward, its wrapper and the
autograd function that training runs.

Port of ``repro.kernels.flash_attention.flash_attention`` (a Pallas TPU
forward kernel under a ``jax.custom_vjp`` whose backward ``_bwd_ref`` is
plain jnp). The kernels are in ``csrc/flash_attention.cu``, behind one
entry point, in two designs: ``"wgmma"`` for hd 128 (the training path),
``"wgmma80"`` for hd 80 (zamba2's shared attention block) and
``"wgmma64"`` for hd 64 (whisper's encoder, cross and static prefill
attention), one template of TMA loads into a ring of tiles and Hopper's
warpgroup products; ``"mma"`` for hd 8, 12 and 16 (the smoke configs), an
``mma.sync`` template over 16-value rows. Their plain version is
``ref.flash_attention_fwd_plain`` (the same (o, lse)).
``FlashAttention``
runs the kernel forward, saves ``(q, k, v, o, lse)`` as ``_vjp_fwd`` does,
and its backward is ``ref.flash_attention_bwd_plain``, the port of
``_bwd_ref``: the JAX package has no backward kernel either. Each kernel
has one fixed summation order, so remat's recompute of a layer gives the
forward's bits.

``flash_attention.launches`` counts the launches by route.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

ROUTES = {8: "mma", 12: "mma", 16: "mma", 64: "wgmma64", 80: "wgmma80",
          128: "wgmma"}                                   # hd -> kernel
HEAD_DIMS = tuple(ROUTES)
_VP, _INT, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, k, v, o, lse; B, Sq, Skv, H, K, hd; scale, cap; causal, window,
# q_offset; stream
_SIG = ([_VP] * 5 + [_INT] * 6 + [_F, _F] + [_INT] * 3 + [_VP], _INT)


def _lib():
    return build.load("flash_attention", {"flash_attention_fwd": _SIG})


def route(hd: int) -> str:
    """The kernel that takes head dim ``hd``: "wgmma" (128), "wgmma80"
    (80), "wgmma64" (64) or "mma" (8, 12, 16). Raises ValueError naming
    the head dims for any other."""
    if hd not in ROUTES:
        raise ValueError(f"flash_attention: the kernel takes head dims "
                         f"{HEAD_DIMS} (128 -> wgmma, 80 -> wgmma80, 64 -> "
                         f"wgmma64, 8/12/16 -> mma), got {hd}")
    return ROUTES[hd]


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
    if k.shape[1] == 0:
        raise ValueError("flash_attention: k/v hold no keys")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise ValueError("flash_attention: the kernel takes bf16 q, k, v, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    route(hd)
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
    contiguous on one card, hd 128 (route "wgmma"), 80 ("wgmma80"), 64
    ("wgmma64") or 8, 12, 16 ("mma"), Skv >= 1; query row i sits at
    absolute position ``q_offset + i``. Returns (o (B, Sq, H, hd) bf16,
    lse (B, Sq, H) fp32)."""
    _check(q, k, v, window, q_offset)
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    r = route(hd)
    scale = hd ** -0.5 if scale is None else scale
    o = torch.empty_like(q)
    lse = torch.empty((B, Sq, H), dtype=torch.float32, device=q.device)
    with build.on_device(q):
        rc = _lib().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, Sq, Skv, H, K, hd, float(scale),
            0.0 if cap is None else float(cap), int(causal),
            0 if window is None else int(window), int(q_offset),
            build.current_stream(q))
    if rc != 0:
        why = {-1: "no tensor maps", -2: "no route for this head dim"}.get(
            rc, f"cudaError {rc}")
        raise RuntimeError(f"flash_attention route {r} launch failed: {why}")
    flash_attention.launches[r] += 1
    return o, lse


flash_attention.launches = Counter()


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

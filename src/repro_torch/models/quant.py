"""Quantized KV-cache representations: int8 / fp8 page pools (port of
``repro.models.quant``).

A quantized pool stores each (token, kv head) row of head_dim values in a
narrow dtype with one fp32 scale beside it: pool (L, num_blocks,
block_size, K, hd) int8 or fp8 e4m3, scale pool (L, num_blocks,
block_size, K, 1) fp32, with the block axis at the same place so the
engine's block copies treat both alike. Symmetric absmax scaling over the
head dim keeps the quantizer a pure elementwise function of its input, so
bit-identical K/V quantizes to bit-identical pages, and ``quantize_kv``
gives the JAX package's bits (round half to even in both).

Dequantization always goes through bf16: ``(q.float() * scale).bfloat16()``
in the kernels and the plain paths alike, so every path attends the same
operands.
"""

from __future__ import annotations

import torch

# Serving KV dtypes by engine / CLI name.
KV_DTYPES = {
    "bf16": torch.bfloat16,
    "int8": torch.int8,
    "fp8": torch.float8_e4m3fn,
}

# Largest representable magnitude per quantized dtype (symmetric).
QMAX = {"int8": 127.0, "fp8": 448.0}

# Guards the absmax so an all-zero row gets scale eps/qmax, not 0.
_AMAX_EPS = 1e-6


def is_quantized(kv_dtype: str) -> bool:
    return kv_dtype in QMAX


def kv_dtype_bytes(kv_dtype: str) -> int:
    """Bytes per pool element for a serving kv dtype name."""
    return KV_DTYPES[kv_dtype].itemsize


def kv_dtype_name(dtype) -> str:
    """Serving kv-dtype name of a pool's dtype (inverse of KV_DTYPES)."""
    for name, dt in KV_DTYPES.items():
        if dt == dtype:
            return name
    raise ValueError(f"not a serving kv dtype: {dtype}")


def quantize_kv(x, kv_dtype: str):
    """Quantize new K/V rows to the pool dtype.

    x: (..., hd) bf16/fp32. Returns (q (..., hd) narrow dtype, scale
    (..., 1) fp32): symmetric per-row absmax over the head dim; int8
    rounds half to even, fp8 takes the cast's rounding after a clip to
    +-qmax.
    """
    qmax = QMAX[kv_dtype]
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=_AMAX_EPS) / qmax
    y = xf / scale
    if kv_dtype == "int8":
        q = torch.clamp(torch.round(y), -qmax, qmax).to(torch.int8)
    else:
        q = torch.clamp(y, -qmax, qmax).to(KV_DTYPES[kv_dtype])
    return q, scale


def dequantize_kv(q, scale, out_dtype=torch.bfloat16):
    """Inverse of ``quantize_kv``: (q (..., hd), scale (..., 1)) -> bf16.
    The bf16 round trip is the one the kernels apply in-tile."""
    return (q.float() * scale).to(out_dtype)


def take_rows(pages, idx):
    """``pages[idx]`` for any pool dtype: 1-byte pools are indexed through
    their raw bytes, which every device and PyTorch build can gather."""
    if pages.dtype.itemsize == 1:
        return pages.view(torch.uint8)[idx].view(pages.dtype)
    return pages[idx]

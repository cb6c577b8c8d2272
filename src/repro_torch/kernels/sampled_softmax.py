"""Fused sampled-softmax loss: the hand-written CUDA kernel's wrapper.

Port of ``repro.kernels.sampled_softmax.sampled_softmax_loss`` (a Pallas
TPU kernel over 256-row tiles; forward only, no VJP). The true-class and
sampled rows come from the port's gather kernel, as on the TPU they come
from the Pallas gather. The kernel is ``csrc/sampled_softmax.cu``; its
plain version is ``ref.sampled_softmax_loss_ref``, which
``kernels.ops.sampled_softmax_loss`` runs for CPU tensors. No model path
calls either, in this package or in the JAX package: the models' sampled
softmax (``models.embedding.sampled_softmax_loss``) is plain tensor code.

``sampled_softmax_loss.launches`` counts the kernel's launches (one per
call, which runs its three passes).
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels import embedding as emb

TILE = 64                       # rows per block and columns per tile
_VP, _INT, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib():
    lib = build.load("sampled_softmax")
    lib.sampled_softmax_loss.argtypes = [_VP] * 9 + [_INT] * 5 + [_F, _VP]
    lib.sampled_softmax_loss.restype = _INT
    return lib


def _check(x, table, labels, sampled_ids):
    if x.dim() != 2 or table.dim() != 2 or x.shape[1] != table.shape[1]:
        raise ValueError(f"sampled_softmax_loss: x (T, d) and table (V, d) "
                         f"expected, got {tuple(x.shape)}, "
                         f"{tuple(table.shape)}")
    T, d = x.shape
    if labels.shape != (T,) or sampled_ids.dim() != 1 \
            or sampled_ids.shape[0] < 1:
        raise ValueError(f"sampled_softmax_loss: labels ({T},) and "
                         f"sampled_ids (n,) expected, got "
                         f"{tuple(labels.shape)}, "
                         f"{tuple(sampled_ids.shape)}")
    if x.dtype != torch.bfloat16 or table.dtype != torch.bfloat16:
        raise ValueError(f"sampled_softmax_loss: the kernel takes bf16 x "
                         f"and table, got {x.dtype}, {table.dtype}")
    if d % TILE:
        raise ValueError(f"sampled_softmax_loss: d must be a multiple of "
                         f"{TILE}, got {d}")
    for name, t in (("x", x), ("table", table), ("labels", labels),
                    ("sampled_ids", sampled_ids)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"sampled_softmax_loss: {name} must be on "
                             f"{x.device} (a CUDA device), got {t.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("sampled_softmax_loss: x must be contiguous and "
                         "16-byte aligned")


def sampled_softmax_loss(x, table, labels, sampled_ids, *, cap=None):
    """CUDA sampled-softmax loss. x (T, d) bf16, d a multiple of 64; table
    (V, d) bf16; labels (T,), sampled_ids (n,) integer ids into the table.
    Returns the mean loss over T, an fp32 scalar tensor."""
    _check(x, table, labels, sampled_ids)
    T, d = x.shape
    n = sampled_ids.shape[0]
    labels = labels.to(torch.int32).contiguous()
    sids = sampled_ids.to(torch.int32).contiguous()
    w_true = emb.gather(table, labels)                     # (T, d)
    w_samp = emb.gather(table, sids)                       # (n, d)
    # split the sampled columns until there are about two blocks per SM
    n_tiles, row_tiles = -(-n // TILE), -(-T // TILE)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    per = -(-n_tiles // min(n_tiles, math.ceil(2 * sms / row_tiles)))
    nsplit = -(-n_tiles // per)
    f32 = dict(dtype=torch.float32, device=x.device)
    m_part = torch.empty((T, nsplit), **f32)
    l_part = torch.empty((T, nsplit), **f32)
    row_loss = torch.empty((T,), **f32)
    out = torch.empty((1,), **f32)
    with torch.cuda.device(x.device):
        rc = _lib().sampled_softmax_loss(
            x.data_ptr(), w_true.data_ptr(), labels.data_ptr(),
            w_samp.data_ptr(), sids.data_ptr(), m_part.data_ptr(),
            l_part.data_ptr(), row_loss.data_ptr(), out.data_ptr(), T, d, n,
            per, nsplit, 0.0 if cap is None else float(cap),
            build.current_stream(x))
    if rc != 0:
        raise RuntimeError(f"sampled_softmax_loss launch failed: cudaError "
                           f"{rc}")
    sampled_softmax_loss.launches += 1
    return out[0]


sampled_softmax_loss.launches = 0

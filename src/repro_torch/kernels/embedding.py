"""Embedding-row gather: the hand-written CUDA kernel and its plain version.

Port of ``repro.kernels.embedding.gather`` (a Pallas TPU kernel driven by
scalar-prefetched ids). The kernel is ``csrc/embedding.cu``; the plain
version is ``gather_plain`` (``table[ids]``), which ``kernels.ops`` runs
for CPU tensors. ``Gather`` puts the kernel under autograd: its backward is
the plain gradient of ``table[ids]``, a scatter-add of the row gradients
into zeros of the table's shape (the JAX package has no backward kernel
for the gather either; XLA differentiates it).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build


def gather_plain(table, ids):
    """table: (V, d); ids: integer of any shape -> (*ids.shape, d)."""
    return table[ids.long()]


_SIG = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
        ctypes.c_int)


def _lib():
    return build.load("embedding", {"embedding_gather": _SIG})


def gather(table, ids):
    """CUDA gather ``table[ids]``. table: (V, d) contiguous on the card,
    rows a multiple of 16 bytes; ids: int32 of any shape on the same card.
    Returns (*ids.shape, d) in table.dtype. Ids are clamped into [0, V).
    Raises ValueError on what the kernel does not take: shapes and types
    first, then devices."""
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError(f"gather: table must be 2-D contiguous, got "
                         f"{tuple(table.shape)}")
    if ids.dtype != torch.int32:
        raise ValueError(f"gather: ids must be int32, got {ids.dtype}")
    V, d = table.shape
    row_bytes = d * table.element_size()
    if row_bytes % 16 or table.data_ptr() % 16:
        raise ValueError("gather: table rows must be 16-byte multiples at a "
                         f"16-byte aligned address (row bytes {row_bytes})")
    if not (table.is_cuda and ids.is_cuda and table.device == ids.device):
        raise ValueError("gather: table and ids must be on the same CUDA "
                         f"device (got {table.device}, {ids.device})")
    flat = ids if ids.dim() == 1 and ids.is_contiguous() \
        else ids.reshape(-1).contiguous()
    out = table.new_empty((flat.shape[0], d))
    with build.on_device(table):
        rc = _lib().embedding_gather(
            table.data_ptr(), flat.data_ptr(), out.data_ptr(),
            flat.shape[0], V, row_bytes, build.current_stream(table))
    if rc != 0:
        raise RuntimeError(f"embedding_gather launch failed: cudaError {rc}")
    gather.launches += 1
    return out if flat is ids else out.reshape(*ids.shape, d)


gather.launches = 0


class Gather(torch.autograd.Function):
    """``table[ids]`` through the CUDA kernel, with the table's gradient.
    The kernel writes into a fresh tensor that autograd knows nothing of,
    so without this an embedding table on the card would get no
    gradient."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.table_shape = table.shape
        return gather(table, ids)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        d = ctx.table_shape[1]
        g = torch.zeros(ctx.table_shape, dtype=grad.dtype, device=grad.device)
        g.index_put_((ids.reshape(-1).long(),), grad.reshape(-1, d),
                     accumulate=True)
        return g, None

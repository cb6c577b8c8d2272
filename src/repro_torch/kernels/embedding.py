"""Embedding-row gather: the hand-written CUDA kernel and its plain version.

Port of ``repro.kernels.embedding.gather`` (a Pallas TPU kernel driven by
scalar-prefetched ids). The kernel is ``csrc/embedding.cu``; the plain
version is ``gather_plain`` (``table[ids]``), which ``kernels.ops`` runs
for CPU tensors. ``Gather`` puts the kernel under autograd: its backward is
the plain gradient of ``table[ids]``, a scatter-add of the row gradients
into zeros of the table's shape (the JAX package has no backward kernel
for the gather either; XLA differentiates it). Ids follow jnp's rule in
all three (``table_rows``): a negative id counts from the end, then the
row is clamped; the gradient of an id still out of range is dropped, as
jax.grad drops it.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build


def table_rows(ids, V):
    """The JAX package's index rule for ``table[ids]`` (jnp indexing): a
    negative id counts from the end (id + V), then the row is clamped into
    [0, V - 1]. Returns (rows, inside): int64 rows, and whether the
    wrapped id was in range, which is where the gradient of ``table[ids]``
    lands (jax.grad drops the others)."""
    ids = ids.long()
    wrapped = torch.where(ids < 0, ids + V, ids)
    return wrapped.clamp(0, V - 1), (wrapped >= 0) & (wrapped < V)


def gather_plain(table, ids):
    """table: (V, d); ids: integer of any shape -> (*ids.shape, d), rows
    chosen by ``table_rows``. Differentiable in the table as jax.grad of
    ``table[ids]``: an id out of range after the wrap reads its clamped
    row but adds nothing to the gradient."""
    rows, inside = table_rows(ids, table.shape[0])
    out = table[rows]
    if not table.requires_grad:
        return out
    return torch.where(inside[..., None], out, out.detach())


_SIG = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
        ctypes.c_int)


def _lib():
    return build.load("embedding", {"embedding_gather": _SIG})


def path(table) -> str:
    """The kernel path ``gather`` takes for ``table``: "vector" (16-byte
    loads) where the row bytes are a multiple of 16 at a 16-byte aligned
    address, "words" (4-byte words: the dataflow core's narrow float32
    rows, or a table at a 4-byte aligned offset) where they are a multiple
    of 4, else "refused" (ValueError by name)."""
    row_bytes = table.shape[-1] * table.element_size()
    if row_bytes % 16 == 0 and table.data_ptr() % 16 == 0:
        return "vector"
    if row_bytes % 4 == 0 and table.data_ptr() % 4 == 0:
        return "words"
    return "refused"


def gather(table, ids):
    """CUDA gather ``table[ids]``. table: (V, d) contiguous on the card,
    rows a whole number of 4-byte words at a 4-byte aligned address (rows
    of 16-byte multiples at 16-byte addresses take 16-byte vectors; the
    rest 4-byte words); ids: int32 of any shape on the same card. Returns
    (*ids.shape, d) in table.dtype. Rows follow ``table_rows`` (a negative
    id counts from the end, then clamped into [0, V)). Raises ValueError on
    what the kernel does not take: shapes and types first, then devices."""
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError(f"gather: table must be 2-D contiguous, got "
                         f"{tuple(table.shape)}")
    if ids.dtype != torch.int32:
        raise ValueError(f"gather: ids must be int32, got {ids.dtype}")
    V, d = table.shape
    row_bytes = d * table.element_size()
    if path(table) == "refused":
        raise ValueError("gather: table rows must be whole 4-byte words at "
                         "a 4-byte aligned address (row bytes "
                         f"{row_bytes})")
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
        V, d = ctx.table_shape
        rows, inside = table_rows(ids.reshape(-1), V)
        # the rows the forward read; an id out of range after the wrap
        # adds zeros there (jax.grad of table[ids] drops it)
        grad = torch.where(inside[:, None], grad.reshape(-1, d), 0.0)
        g = torch.zeros(ctx.table_shape, dtype=grad.dtype, device=grad.device)
        g.index_put_((rows,), grad, accumulate=True)
        return g, None

"""Exact collectives of tensor-parallel serving, over the mesh's "model"
process group (the port's own: the JAX package leaves its gathers to
GSPMD's ``with_sharding_constraint``).

A ``ModelGroup`` wraps one "model" group of a ``launch.mesh`` mesh: its
size (the tensor-parallel degree), this process's rank in it, the
all-gather along a head axis that restores every head of a per-kv-head
result, and the host messages that keep the ranks' schedulers in step
(``broadcast``, ``all_gather_object``). Gathers move bytes: a tensor is
sent as its ``uint8`` view and comes back bit for bit, whatever its dtype.

Under NCCL a CUDA tensor is gathered on the card. Under gloo (the CPU, or
several ranks on one card, which NCCL refuses) a CUDA tensor goes through
pinned host memory: one copy to the host, the gather of host tensors, one
copy back. ``stats`` counts the gathers, their bytes, and the staged
copies and their bytes.

The engine makes its group the current one (``use``) around each step;
``current()`` is what the model code reads, as the JAX package's reads
the ambient mesh. Thread-local: engines stepped by different threads keep
their own.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed as dist

__all__ = ["ModelGroup", "current", "use"]

_LOCAL = threading.local()


class ModelGroup:
    """One "model" group of a mesh: ``size`` ranks, this one ``rank``."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.backend = str(dist.get_backend(group))
        # the group's rank 0, as a global rank (what broadcast names)
        self.src = dist.get_global_rank(group, 0)
        self.stats = {"gathers": 0, "gather_bytes": 0, "staged_copies": 0,
                      "staged_bytes": 0}
        self._pinned = {}            # nbytes -> (send, receive) host buffers

    def _staging(self, nbytes: int):
        bufs = self._pinned.get(nbytes)
        if bufs is None:
            bufs = (torch.empty(nbytes, dtype=torch.uint8, pin_memory=True),
                    torch.empty((self.size, nbytes), dtype=torch.uint8,
                                pin_memory=True))
            self._pinned[nbytes] = bufs
        return bufs

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` (one shape on all) concatenated along
        ``dim`` in rank order: an exact copy."""
        d = dim % x.dim()
        x = x.contiguous()
        raw = x.view(-1).view(torch.uint8)
        n = raw.numel()
        if x.is_cuda and self.backend == "nccl":
            got = torch.empty((self.size, n), dtype=torch.uint8,
                              device=x.device)
            dist.all_gather_into_tensor(got, raw, group=self.group)
        elif x.is_cuda:
            send, recv = self._staging(n)
            send.copy_(raw)                  # waits for x on its stream
            dist.all_gather(list(recv.unbind(0)), send, group=self.group)
            got = recv.to(x.device)
            self.stats["staged_copies"] += 2
            self.stats["staged_bytes"] += n * (1 + self.size)
        else:
            got = torch.empty((self.size, n), dtype=torch.uint8)
            dist.all_gather(list(got.unbind(0)), raw, group=self.group)
        self.stats["gathers"] += 1
        self.stats["gather_bytes"] += n * self.size
        parts = got.view(x.dtype).view((self.size,) + tuple(x.shape))
        shape = list(x.shape)
        shape[d] *= self.size
        return parts.movedim(0, d).reshape(shape)

    def broadcast(self, obj=None):
        """Rank 0's ``obj`` on every rank of the group (a pickled host
        object)."""
        box = [obj]
        dist.broadcast_object_list(box, src=self.src, group=self.group)
        return box[0]

    def all_gather_object(self, obj) -> list:
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out


def current() -> ModelGroup | None:
    """The model group of the step running on this thread, or None."""
    return getattr(_LOCAL, "group", None)


@contextlib.contextmanager
def use(group: ModelGroup | None):
    """Make ``group`` the current one on this thread for the block."""
    prev = current()
    _LOCAL.group = group
    try:
        yield group
    finally:
        _LOCAL.group = prev

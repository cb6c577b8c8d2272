"""Exact collectives over the mesh's process groups, for tensor-parallel
serving and for multi-rank training (the port's own: the JAX package
leaves them to GSPMD and ``shard_map``).

A ``ModelGroup`` wraps one group of a ``launch.mesh`` mesh (a "model"
group, or a "data" group in training): its size, this process's rank in
it, and the operations below. Every transfer moves bytes: a tensor is
sent as its ``uint8`` view and arrives bit for bit, whatever its dtype.

- ``gather`` (all-gather along a dim, in rank order);
- ``reduce_scatter``: the tensor cut into ``size`` chunks along a dim,
  chunk r sent to rank r (``all_to_all``), and each rank sums the chunks
  it received in rank order in fp32 (``mean``: then divides by the size);
- ``all_reduce``: ``reduce_scatter`` of the flat tensor, then ``gather``.
  Each element is summed once, on one rank, in rank order, so every rank
  holds the same bits, whatever the backend's own reduction order;
- ``all_to_all`` (chunk r of dim 0 to rank r), ``broadcast`` and
  ``all_gather_object`` of host objects.

Under NCCL a CUDA tensor moves on the card. Under gloo (the CPU, or
several ranks on one card, which NCCL refuses) a CUDA tensor goes through
pinned host memory: one copy to the host, the exchange of host tensors,
one copy back; a model tensor never stays on the host. ``stats`` counts
the operations, their bytes, and the staged copies and their bytes.

Training's autograd pair (Megatron-style tensor parallelism over the
"model" group) and the sequence gather: ``copy_to`` (identity forward,
all-reduce of the gradient backward: where a replicated tensor enters
sharded work), ``reduce_from`` (all-reduce forward, identity backward:
where partial results leave it) and ``gather_seq`` (all-gather forward,
this rank's slice of the gradient backward).

The engine makes its ``ServeMesh`` (the serving mesh's "model", "data"
and whole-mesh groups) the current one (``use``) around each step;
``serving()`` and ``current()`` (its "model" group) are what the serving
model code reads, as the JAX package's reads the ambient mesh.
Thread-local: engines stepped by different threads keep their own. The
train step makes its ``TrainMesh`` current
(``use_train``) around the forward and backward; ``train()`` and
``tp_group()`` are what the training model code reads. That one is
process-wide: the autograd engine runs a CUDA backward, and remat's
recompute of the forward inside it, on a thread of its own (a
thread-local mesh would be missing there, and the recompute would skip
its collectives).

``shard_group`` is how a weight finds the group whose shard it holds, in
serving as in training: by the size of its sharded dim against the whole
one (the serving mesh's "model" group, then its whole mesh for grok-1's
expert d_ff over (data, model); the training mesh's "model" group).
"""

from __future__ import annotations

import contextlib
import threading
from collections import Counter

import torch
import torch.distributed as dist

__all__ = ["ModelGroup", "TrainMesh", "ServeMesh", "train_mesh", "current",
           "serving", "use", "train", "use_train", "tp_group",
           "shard_group", "copy_to", "reduce_from",
           "gather_seq"]

_LOCAL = threading.local()
_TRAIN: list = [None]            # the process's current TrainMesh


class ModelGroup:
    """One process group of a mesh: ``size`` ranks, this one ``rank``."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.backend = str(dist.get_backend(group))
        # the group's rank 0, as a global rank (what broadcast names)
        self.src = dist.get_global_rank(group, 0)
        self.stats = {"gathers": 0, "gather_bytes": 0, "staged_copies": 0,
                      "staged_bytes": 0, "reduces": 0, "reduce_bytes": 0,
                      "all_to_alls": 0}
        self._pinned = {}        # op -> (send, receive) host buffers

    def _staging(self, op: str, nbytes: int):
        """(send, receive) pinned views of ``nbytes`` and of what ``op``
        receives for them (size x nbytes for "gather", nbytes for
        "all_to_all"), from one pair of buffers per operation that grows
        to the largest call."""
        m = nbytes * (self.size if op == "gather" else 1)
        bufs = self._pinned.get(op)
        if bufs is None or bufs[0].numel() < nbytes:
            bufs = (torch.empty(nbytes, dtype=torch.uint8, pin_memory=True),
                    torch.empty(m, dtype=torch.uint8, pin_memory=True))
            self._pinned[op] = bufs
        return bufs[0][:nbytes], bufs[1][:m]

    def _exchange(self, raw: torch.Tensor, op: str) -> torch.Tensor:
        """``raw`` (n,) uint8 of this rank -> (size, n) uint8 on raw's
        device: row r is rank r's ``raw`` ("gather") or rank r's chunk
        for this rank, raw seen as (size, n / size) ("all_to_all")."""
        n = raw.numel()
        if raw.is_cuda and self.backend == "nccl":
            if op == "gather":
                got = torch.empty((self.size, n), dtype=torch.uint8,
                                  device=raw.device)
                dist.all_gather_into_tensor(got, raw, group=self.group)
                return got
            got = torch.empty_like(raw)
            dist.all_to_all_single(got, raw, group=self.group)
            return got.view(self.size, n // self.size)
        if raw.is_cuda:
            send, recv = self._staging(op, n)
            send.copy_(raw)                   # waits for raw on its stream
            host = self._host_exchange(send, recv, op)
            got = host.to(raw.device)
            self.stats["staged_copies"] += 2
            self.stats["staged_bytes"] += n + host.numel()
            return got
        recv = torch.empty(n * (self.size if op == "gather" else 1),
                           dtype=torch.uint8)
        return self._host_exchange(raw, recv, op)

    def _host_exchange(self, send, recv, op):
        """``send`` (n,) exchanged into ``recv`` (flat host buffer) ->
        (size, n) for "gather", (size, n / size) for "all_to_all"."""
        n = send.numel()
        if op == "gather":
            recv = recv.view(self.size, n)
            dist.all_gather(list(recv.unbind(0)), send, group=self.group)
            return recv
        dist.all_to_all_single(recv, send, group=self.group)
        return recv.view(self.size, n // self.size)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` (one shape on all) concatenated along
        ``dim`` in rank order: an exact copy."""
        d = dim % x.dim()
        if self.size == 1:
            return x
        x = x.contiguous()
        got = self._exchange(x.view(-1).view(torch.uint8), "gather")
        self.stats["gathers"] += 1
        self.stats["gather_bytes"] += got.numel()
        parts = got.view(x.dtype).view((self.size,) + tuple(x.shape))
        shape = list(x.shape)
        shape[d] *= self.size
        return parts.movedim(0, d).reshape(shape)

    def gather_to_root(self, x: torch.Tensor, dim: int):
        """``gather``'s result on the group's rank 0 only, on the host
        (what a checkpoint writer needs: half the bytes of an
        all-gather); None on the other ranks."""
        d = dim % x.dim()
        if self.size == 1:
            return x
        x = x.contiguous()
        raw = x.view(-1).view(torch.uint8)
        n = raw.numel()
        if x.is_cuda and self.backend == "nccl":
            got = [torch.empty_like(raw) for _ in range(self.size)] \
                if self.rank == 0 else None
            dist.gather(raw, got, dst=self.src, group=self.group)
            got = torch.stack(got).cpu() if got is not None else None
        else:
            if x.is_cuda:
                send, _ = self._staging("gather_to_root", n)
                send.copy_(raw)
                self.stats["staged_copies"] += 1
                self.stats["staged_bytes"] += n
                raw = send
            got = (torch.empty((self.size, n), dtype=torch.uint8)
                   if self.rank == 0 else None)
            dist.gather(raw, list(got.unbind(0)) if got is not None
                        else None, dst=self.src, group=self.group)
        self.stats["gathers"] += 1
        self.stats["gather_bytes"] += n * self.size
        if got is None:
            return None
        parts = got.view(x.dtype).view((self.size,) + tuple(x.shape))
        shape = list(x.shape)
        shape[d] *= self.size
        return parts.movedim(0, d).reshape(shape)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """x (size, ...) -> (size, ...): row r of the result is rank r's
        row ``self.rank``; exact."""
        if x.shape[0] != self.size:
            raise ValueError(f"all_to_all: dim 0 of {tuple(x.shape)} must "
                             f"be the group size {self.size}")
        x = x.contiguous()
        got = self._exchange(x.view(-1).view(torch.uint8), "all_to_all")
        self.stats["all_to_alls"] += 1
        return got.reshape(-1).view(x.dtype).view(x.shape)

    def reduce_scatter(self, x: torch.Tensor, dim: int = 0,
                       mean: bool = False, dtype=None) -> torch.Tensor:
        """This rank's chunk (rank order along ``dim``, whose size the
        group size divides) of the sum over ranks of ``x``, summed in fp32
        in rank order (divided by the size with ``mean``), in ``dtype``
        (default fp32)."""
        d = dim % x.dim()
        if x.shape[d] % self.size:
            raise ValueError(f"reduce_scatter: dim {d} of {tuple(x.shape)} "
                             f"is not a multiple of {self.size}")
        chunks = torch.stack(x.chunk(self.size, dim=d))  # (size, chunk...)
        got = self.all_to_all(chunks)
        self.stats["reduces"] += 1
        self.stats["reduce_bytes"] += x.numel() * x.element_size()
        acc = got[0].float()
        for r in range(1, self.size):
            acc = acc + got[r].float()
        if mean:
            acc = acc / self.size
        return acc.to(dtype or torch.float32)

    def all_reduce(self, x: torch.Tensor, mean: bool = False,
                   dtype=None) -> torch.Tensor:
        """The sum (``mean``: the mean) over ranks of ``x``, each element
        summed once in fp32 in rank order on one rank, in ``dtype``
        (default x's): the same bits on every rank."""
        if self.size == 1:
            return x.to(dtype or x.dtype)
        flat = x.reshape(-1)
        pad = (-flat.numel()) % self.size
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        part = self.reduce_scatter(flat, 0, mean, dtype or x.dtype)
        full = self.gather(part, 0)
        return full[:x.numel()].view(x.shape)

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


class TrainMesh:
    """The ("data", "model") groups of a training mesh (a
    ``launch.mesh.make_host_mesh`` DeviceMesh): ``data`` and ``model``
    ModelGroups, ``shape`` {axis: size} and this rank's ``coords`` {axis:
    index}. Rank ``d * model + m`` sits at (d, m)."""

    def __init__(self, mesh):
        self.data = ModelGroup(mesh.get_group("data"))
        self.model = ModelGroup(mesh.get_group("model"))
        self.shape = {"data": self.data.size, "model": self.model.size}
        self.coords = {"data": self.data.rank, "model": self.model.rank}

    def group(self, axis: str) -> ModelGroup:
        return {"data": self.data, "model": self.model}[axis]

    @property
    def stats(self) -> dict:
        """Both groups' counters, summed."""
        return {k: self.data.stats[k] + self.model.stats[k]
                for k in self.data.stats}


class ServeMesh:
    """The groups of a serving mesh (a ``launch.mesh.make_host_mesh``
    DeviceMesh) for one engine: ``model`` (tensor parallelism: kv heads,
    and with sharded weights query heads, ff, vocab rows and experts),
    ``data`` and ``both``, every rank of the mesh in its (data, model)
    row-major order (rank ``d * model + m``: grok-1's expert d_ff over
    both axes). Each is a ``ModelGroup`` of its own, so an engine's
    counters are its own. ``f2d`` is grok-1's MoE serving layout
    (``ParallelConfig.expert_ff_2d``: the expert d_ff over both axes, the
    JAX package's ctx "moe_f2d"), which ``models.moe`` reads;
    ``moe_modes`` counts the MoE block's calls by mode."""

    def __init__(self, mesh, f2d: bool = False):
        self.model = ModelGroup(mesh.get_group("model"))
        self.data = ModelGroup(mesh.get_group("data"))
        self.both = (self.model if self.data.size == 1 else
                     self.data if self.model.size == 1 else
                     ModelGroup(dist.group.WORLD))
        if self.both.size != self.data.size * self.model.size:
            raise ValueError("a serving mesh must span the whole process "
                             "group")
        self.f2d = f2d
        self.moe_modes = Counter()

    @property
    def stats(self) -> dict:
        """Every distinct group's counters, summed."""
        groups = {id(g): g for g in (self.model, self.data, self.both)}
        out = dict.fromkeys(self.model.stats, 0)
        for g in groups.values():
            for k, v in g.stats.items():
                out[k] += v
        return out


def train_mesh(mesh) -> TrainMesh:
    """The ``TrainMesh`` of a DeviceMesh, made once per mesh (its groups'
    staging buffers and counters are shared by every user)."""
    tm = getattr(mesh, "_train_mesh", None)
    if tm is None:
        tm = TrainMesh(mesh)
        mesh._train_mesh = tm
    return tm


def serving() -> ServeMesh | None:
    """The serving mesh of the step running on this thread, or None."""
    return getattr(_LOCAL, "mesh", None)


def current() -> ModelGroup | None:
    """The serving "model" group of the step running on this thread, or
    None."""
    sm = serving()
    return None if sm is None else sm.model


@contextlib.contextmanager
def use(mesh: ServeMesh | None):
    """Make ``mesh`` the current serving mesh on this thread for the
    block."""
    prev = serving()
    _LOCAL.mesh = mesh
    try:
        yield mesh
    finally:
        _LOCAL.mesh = prev


def train() -> TrainMesh | None:
    """The training mesh of the step running in this process, or None."""
    return _TRAIN[0]


@contextlib.contextmanager
def use_train(mesh: TrainMesh | None):
    """Make ``mesh`` the process's current training mesh for the block
    (every thread sees it: the autograd engine's too)."""
    prev = train()
    _TRAIN[0] = mesh
    try:
        yield mesh
    finally:
        _TRAIN[0] = prev


def tp_group() -> ModelGroup | None:
    """The current training mesh's "model" group when it shards (size >
    1), else None."""
    tm = train()
    return tm.model if tm is not None and tm.model.size > 1 else None


def shard_group(held: int, whole: int, what: str) -> ModelGroup | None:
    """The group whose shard a leaf is, by the size of its sharded dim:
    None where it holds all ``whole`` entries; where it holds ``whole /
    n``, the current serving mesh's "model" group or its whole mesh (n
    their sizes, in that order), or the current training mesh's sharding
    "model" group; else a ValueError naming ``what`` (a shard outside a
    mesh, or of another mesh)."""
    if held == whole:
        return None
    sm = serving()
    for grp in ((sm.model, sm.both) if sm is not None else (tp_group(),)):
        if grp is not None and grp.size > 1 and held * grp.size == whole:
            return grp
    raise ValueError(f"{what} of {held} is not a shard of {whole} under "
                     "the current mesh")


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return group.gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        part = g.narrow(ctx.dim, ctx.group.rank * ctx.n, ctx.n)
        return part.contiguous(), None, None


def copy_to(x, group: ModelGroup | None):
    """Identity forward; backward, the gradient all-reduced over
    ``group`` (a replicated tensor entering work each rank does a part
    of). ``x`` itself without a group."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x, group: ModelGroup | None):
    """The sum over ``group`` of every rank's partial ``x`` (fp32 sums in
    rank order, in x's dtype); identity backward. ``x`` without a
    group."""
    return x if group is None else _ReduceFrom.apply(x, group)


def gather_seq(x, group: ModelGroup | None, dim: int = 1):
    """Every rank's block of rows along ``dim``, concatenated in rank
    order; backward, this rank's block of the gradient."""
    return x if group is None else _GatherSeq.apply(x, group, dim)

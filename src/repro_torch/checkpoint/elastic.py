"""Elastic restart: restore a checkpoint onto another device or another
mesh (port of ``repro.checkpoint.elastic``).

Checkpoints hold the global tree as host arrays (the JAX package's
format), so a job may resume on other hardware or another mesh shape: one
written on the card restores on the CPU and the reverse, and one written
at data=2 restores at model=2 or on one device. ``restore_to`` places the
whole tree on a device. ``restore_for_mesh`` is the JAX package's
re-sharding on restore: each rank cuts its shards of every leaf by the
new mesh's layouts (``spmd.steps.train_layouts``) from the files, read
through memory maps (a rank reads its slices only). ``save_global``
gathers every rank's shards (tensor-parallel shards and ZeRO-1 slices of
the masters and slots) into the global tree, which rank 0 writes.
"""

from __future__ import annotations

import torch.distributed as dist

from repro_torch.checkpoint.checkpoint import CheckpointManager


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device)


def restore_to(mgr: CheckpointManager, spec, device, step: int | None = None):
    """Restore the tree shaped like ``spec`` (the latest step by default)
    and place every leaf on ``device``, its dtype kept. Returns (step,
    tree)."""
    step, host = mgr.restore(spec, step)
    return step, _to(host, device)


def restore_for_mesh(mgr: CheckpointManager, spec, mesh, layouts, device,
                     step: int | None = None):
    """Restore the tree shaped like ``spec`` (the latest step by default)
    as this rank's shards on ``mesh`` by ``layouts`` (a tree of
    ``spmd.sharding.Layout`` shaped like ``spec``), each a contiguous
    tensor on ``device``. Returns (step, tree)."""
    import torch

    from repro_torch.spmd import sharding as shd
    from repro_torch.spmd.collectives import train_mesh
    tm = train_mesh(mesh)
    step, host = mgr.restore(spec, step, mmap=True)

    def one(x, lay):
        part = lay.cut(x, tm.coords, tm.shape)
        out = torch.empty(part.shape, dtype=part.dtype, device=device)
        return out.copy_(part)
    return step, shd.map_specs(one, host, layouts)


def save_global(mgr: CheckpointManager | None, step: int, state,
                metric=None, mesh=None, layouts=None):
    """Save ``state`` wherever its tensors live: ``mgr.save`` copies every
    leaf to the host before it returns. On a ``mesh`` every rank calls it
    (the gathers are collectives) with its shards and their ``layouts``;
    the shards are gathered to the host of the mesh's rank (0, 0), global
    rank 0, which saves the global tree (``mgr`` may be None elsewhere)."""
    if mesh is None:
        mgr.save(step, state, metric=metric)
        return
    from repro_torch.spmd import sharding as shd
    from repro_torch.spmd.collectives import train_mesh
    tm = train_mesh(mesh)
    lead = dist.get_rank() == 0
    if lead != all(c == 0 for c in tm.coords.values()):
        raise ValueError("global rank 0 must sit at the mesh's (0, 0)")

    def one(x, lay):
        x = x.detach()
        host = shd.gather_global(x, lay, tm, to_root=True)
        if host is None:
            return None
        # a leaf no rank shards is the live tensor itself on the CPU
        return host.clone() if host.data_ptr() == x.data_ptr() else host

    host = shd.map_specs(one, state, layouts)
    if lead:
        mgr.save(step, host, metric=metric, copy=False)

"""Restore onto a device (port of ``repro.checkpoint.elastic``, its
one-device meaning).

Checkpoints hold host arrays, so a job may resume on other hardware: one
written on the card restores on the CPU and the reverse. Re-sharding a
restored tree over a mesh of several GPUs (the JAX package's
``restore_for_mesh``) waits for tensor parallelism (ROADMAP.md queue 1
item 12).
"""

from __future__ import annotations

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


def save_global(mgr: CheckpointManager, step: int, state, metric=None):
    """Save ``state`` wherever its tensors live: ``mgr.save`` copies every
    leaf to the host before it returns."""
    mgr.save(step, state, metric=metric)

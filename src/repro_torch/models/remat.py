"""Layer rematerialisation for training (the JAX package's ``pcfg.remat``
around its scanned period body).

``"none"`` keeps every activation of the wrapped body for the backward.
``"full"`` keeps only its inputs and recomputes the body in the backward
(``jax.checkpoint`` with no policy). ``"dots"`` is
``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: the outputs
of the body's 2-D matrix products (``aten.mm``, ``aten.addmm``: the
projections and MLPs over flattened rows) are kept, and everything else
is recomputed: batched products (``bmm``: the MoE's expert products, the
plain attention's einsums), the hand-written kernels and the elementwise
work. All three give the same values: the kernels have one fixed
summation order, so a recompute reproduces the forward's bits.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

MODES = ("none", "full", "dots")
DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in DOTS_SAVED
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def remat(fn, mode: str):
    """``fn`` wrapped for ``mode`` ("none", "full" or "dots")."""
    if mode == "none":
        return fn
    if mode == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if mode == "dots":
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 context_fn=_dots_context)
    raise ValueError(f"remat={mode!r}: one of {MODES}")

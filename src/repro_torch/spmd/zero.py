"""ZeRO-1: the optimizer state sharded over the data-parallel axes (port
of ``repro.spmd.zero``).

Each fp32 master and slot leaf gets one more "data" entry, on its first
dim that is not sharded already and that the data size divides
(``zero1_leaf_spec``, as in the JAX package). The bf16 working params
stay whole over "data". The JAX package states this as out_shardings and
lets GSPMD place the collectives; here ``spmd.steps.make_train_step``
runs them: the gradients are reduce-scattered over "data" along that dim
(each rank receives the mean of its slice), each rank updates its slices
of the masters and slots with the unchanged ``optim.optimizers``
update, casts them to bf16 and all-gathers them into the working
params. AdamW is elementwise, so the updated values are the same bits
as without ZeRO-1 (every rank then holds whole masters and slots,
``plain_state_layouts``).
"""

from __future__ import annotations

import math

from repro_torch.spmd import sharding as shd


def zero1_leaf_spec(shape, base_spec: tuple, mesh) -> tuple:
    """Add data-parallel sharding to the first free, divisible dim of a
    slot leaf (global ``shape``)."""
    dp = shd.dp_axes(mesh)
    if not dp:
        return tuple(base_spec)
    entries = list(base_spec) + [None] * (len(shape) - len(base_spec))
    used = set()
    for e in entries:
        for a in (e if isinstance(e, tuple) else (e,)):
            if a:
                used.add(a)
    free_dp = tuple(a for a in dp if a not in used)
    if not free_dp:
        return tuple(base_spec)
    sizes = shd.mesh_shape(mesh)
    size = math.prod(sizes[a] for a in free_dp)
    for i, (dim, e) in enumerate(zip(shape, entries)):
        if e is None and dim % size == 0 and dim >= size:
            entries[i] = free_dp if len(free_dp) > 1 else free_dp[0]
            return tuple(entries)
    return tuple(base_spec)


def zero_dim(layout: shd.Layout) -> int | None:
    """The dim a state layout shards over "data", or None."""
    for d, e in enumerate(layout.spec):
        if e == "data" or (isinstance(e, tuple) and "data" in e):
            return d
    return None


def zero1_state_layouts(shapes, param_layouts, mesh):
    """The master / slot layout of every leaf: its parameter's layout
    with ``zero1_leaf_spec``'s "data" entry (global ``shapes``)."""
    return shd.map_specs(
        lambda shp, lay: lay.with_spec(zero1_leaf_spec(tuple(shp), lay.spec,
                                                       mesh)),
        shapes, param_layouts)


def plain_state_layouts(shapes, param_layouts, mesh):
    """Without ZeRO-1 the state has its parameter's layout."""
    return param_layouts

"""Sharding rules (port of ``repro.spmd.sharding`` on plain tuples).

A spec is a tuple with one entry per tensor dim: None (replicated), a
mesh axis name, or a tuple of names, as the JAX package's
``PartitionSpec``. A mesh is a ``DeviceMesh`` with named dims
(``launch.mesh.make_host_mesh``) or a mapping {axis name: size}.

The serving half: the tensor-parallel engine shards its page pools (k,
v, and the scale pools of quantized ones) and whisper's cross K/V by
whole kv heads over the "model" axis, each rank holding K / tp heads;
Mamba slot state and weights stay whole on every rank, and so does every
piece of host metadata (block tables, refcounts, hashes, the scheduler).

The training half, for the multi-device trainer to come: ``make_rules``
maps logical axis names to mesh axes, ``resolve_spec`` a tensor's logical
axes to a spec, dropping assignments the dims do not divide.
"""

from __future__ import annotations

import math
from typing import Any

from repro_torch.config import ModelConfig, ParallelConfig

Rules = dict[str, Any]   # logical name -> mesh axis | tuple | None

# cache leaves that shard by kv head (axis 3 of their 5-D stacks)
KV_HEAD_LEAVES = ("k", "v", "xk", "xv", "k_scale", "v_scale")


def mesh_shape(mesh) -> dict[str, int]:
    """{axis name: size} of a DeviceMesh or a mapping; {} for None."""
    if mesh is None:
        return {}
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names or (), mesh.shape))


def serving_tp(mesh) -> int:
    """Tensor-parallel degree of the serving engine: the "model" axis."""
    return mesh_shape(mesh).get("model", 1)


def paged_pool_pspec(num_kv_heads: int, tp: int) -> tuple:
    """Spec of a page-pool stack (NP, num_blocks, block_size, K, hd): kv
    heads over "model". Raises for a head count the axis does not divide
    (pools shard by whole kv heads; an engine checks this at
    construction)."""
    if tp > 1 and num_kv_heads % tp != 0:
        raise ValueError(
            f"num_kv_heads={num_kv_heads} is not divisible by the mesh "
            f"model axis ({tp}): page pools shard by whole kv heads. "
            "Choose a model-axis size that divides num_kv_heads, or shard "
            "the blocks axis via the LSE-stitch path (docs/multi-host.md).")
    return (None, None, None, "model" if tp > 1 else None, None)


def kv_heads_per_rank(num_kv_heads: int, tp: int) -> int:
    """kv heads each of ``tp`` tensor-parallel ranks holds of every page
    pool and cross K/V: K / tp, with ``paged_pool_pspec``'s ValueError
    where tp does not divide K."""
    paged_pool_pspec(num_kv_heads, tp)
    return num_kv_heads // tp


def serving_cache_pspec(name: str, shape: tuple, tp: int) -> tuple:
    """Spec of one serving-cache leaf by its name: the 5-D kv-head leaves
    (``KV_HEAD_LEAVES``) shard axis 3 over "model" where it divides;
    everything else (Mamba's conv tails and states) is replicated, ()."""
    if tp <= 1:
        return ()
    if name in KV_HEAD_LEAVES and len(shape) == 5:
        ok = shape[3] % tp == 0
        return (None, None, None, "model" if ok else None, None)
    return ()


def make_rules(cfg: ModelConfig, pcfg: ParallelConfig) -> Rules:
    """The baseline logical-axis rules."""
    moe_ep = cfg.moe is not None and cfg.moe.num_experts >= 16
    return {
        "vocab": "model",
        "embed": "data" if pcfg.fsdp else None,
        "heads": "model",
        "kv_heads": "model",       # dropped where it does not divide
        "head_dim": None,
        "ff": "model",
        "experts": "model" if moe_ep else None,
        "expert_ff": (("data", "model") if pcfg.expert_ff_2d
                      else (None if moe_ep else "model")),
        "expert_embed": "data" if (pcfg.fsdp and not pcfg.expert_ff_2d)
                        else None,
        "ssm_inner": "model",
        "ssm_heads": "model",
        "layers": None,
        None: None,
    }


def resolve_spec(shape: tuple[int, ...], logical: tuple[str | None, ...],
                 rules: Rules, mesh) -> tuple:
    """Logical axes -> a spec, dropping any assignment whose mesh-axis
    product does not divide the dim, and any axis already used."""
    sizes = mesh_shape(mesh)
    out = []
    used: set[str] = set()
    for dim, name in zip(shape, logical):
        ax = rules.get(name, None)
        if ax is None:
            out.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        axes = tuple(a for a in axes if a in sizes and a not in used)
        size = math.prod(sizes[a] for a in axes) if axes else 1
        if axes and dim % size == 0:
            out.append(axes if len(axes) > 1 else axes[0])
            used.update(axes)
        else:
            out.append(None)
    return tuple(out)

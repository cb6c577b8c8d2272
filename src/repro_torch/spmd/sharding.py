"""Sharding rules (port of ``repro.spmd.sharding`` on plain tuples).

A spec is a tuple with one entry per tensor dim: None (replicated), a
mesh axis name, or a tuple of names, as the JAX package's
``PartitionSpec``. A mesh is a ``DeviceMesh`` with named dims
(``launch.mesh.make_host_mesh``) or a mapping {axis name: size}.

The serving half: the tensor-parallel engine shards its page pools (k,
v, and the scale pools of quantized ones) and whisper's cross K/V by
whole kv heads over the "model" axis, each rank holding K / tp heads;
Mamba slot state stays whole on every rank, and so does every piece of
host metadata (block tables, refcounts, hashes, the scheduler). Weights
stay whole too, unless the engine shards them (``shard_params=True``,
dense and MoE decoders): ``serving_layouts`` gives each leaf's cut, by
``make_rules`` over ``models.api.param_specs`` with the kv-group cut of
``wq`` / ``wo`` below: query and kv heads, ff, vocab rows (embedding
table and head) over "model", norms and the router whole. The MoE
leaves are the trap: the JAX package's rules cut expert d_ff for E < 16
but its ``moe_block`` runs an expert-parallel mode whenever tp divides
E, and its in_specs re-lay the weights on every call. Here they are
stored in the cut their block's mode reads (``serving_rules``): whole
experts cut over "model" for "ep_a2a" / "ep_psum", the expert d_ff over
"model" for "tp", and over ("data", "model") for grok-1's ``f2d``
(docs/torch-serving-mesh.md).

The training half (``spmd.steps.make_train_step(..., mesh)``):
``make_rules`` maps logical axis names to mesh axes, ``resolve_spec`` a
tensor's logical axes to a spec, dropping assignments the dims do not
divide; ``tree_pspecs`` does it over a parameter tree and its logical
specs (``models.api.param_specs``); ``batch_spec`` puts the batch rows
over the data axes where they divide (else every data rank computes the
whole batch, as GSPMD replicates it). A ``Layout`` is one leaf's
placement: its spec, and the dims whose heads are cut by kv-head group
(below). ``Layout.cut`` takes one rank's shard of a global tensor from
its mesh coordinates; ``gather_global`` is the inverse over a
``collectives.TrainMesh``, an exact gather of ``uint8`` views.

Query heads are g-major (head h = g * K + k reads kv head k), so a
contiguous cut of ``wq``'s or ``wo``'s heads axis would not be the query
heads of the rank's contiguous kv heads. Where the "model" axis divides K,
those leaves are cut by kv-head group instead: rank r of tp holds, in
this order, the heads g * K + r * K / tp + j for g < H / K, j < K / tp (g
outer), which are the local g-major heads of its K / tp kv heads; the
heads axis is seen as (G, K) and K is cut contiguously. The global tree
(checkpoints) keeps the reference's order. Where tp divides H but not K,
the heads are cut contiguously and the kv heads stay whole on every rank
(``models.attention.train_attention`` picks each local head's kv head).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.config import ModelConfig, ParallelConfig

Rules = dict[str, Any]   # logical name -> mesh axis | tuple | None

DP_AXES = ("pod", "data")

# cache leaves that shard by kv head (axis 3 of their 5-D stacks)
KV_HEAD_LEAVES = ("k", "v", "xk", "xv", "k_scale", "v_scale")


def mesh_shape(mesh) -> dict[str, int]:
    """{axis name: size} of a DeviceMesh or a mapping; {} for None."""
    if mesh is None:
        return {}
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names or (), mesh.shape))


def dp_axes(mesh) -> tuple[str, ...]:
    """Data-parallel axes present in the mesh ("pod" folds into data
    parallelism, as in the JAX package)."""
    return tuple(a for a in DP_AXES if a in mesh_shape(mesh))


def batch_spec(global_batch: int, mesh, extra_dims: int = 1) -> tuple:
    """Spec of (B, ...) activations: the batch over the data axes when
    their product divides it, else replicated."""
    sizes = mesh_shape(mesh)
    dp = dp_axes(mesh)
    size = math.prod(sizes[a] for a in dp) if dp else 1
    first = dp if (dp and global_batch % size == 0) else None
    if isinstance(first, tuple) and len(first) == 1:
        first = first[0]
    return (first,) + (None,) * extra_dims


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


def map_specs(fn, params, specs):
    """``fn(leaf, spec)`` over a parameter tree (dicts and lists) and its
    spec tree, whose tuples are leaves; the result is shaped like
    ``params``."""
    if isinstance(params, dict):
        return {k: map_specs(fn, params[k], specs[k]) for k in params}
    if isinstance(params, list):
        return [map_specs(fn, p, s) for p, s in zip(params, specs)]
    return fn(params, specs)


def tree_pspecs(params, specs, rules: Rules, mesh):
    """The resolved spec of every leaf of ``params`` (tensors or shapes)
    from its logical ``specs``."""
    def one(p, s):
        shape = p.shape if isinstance(p, torch.Tensor) else p
        return resolve_spec(tuple(shape), s, rules, mesh)
    return map_specs(one, params, specs)


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class Layout:
    """One leaf's placement on a mesh: ``spec`` (one entry per dim) and
    ``groups``, ((dim, K), ...): dims of H = G * K query heads whose
    shard is a block of kv heads (module docstring)."""
    spec: tuple
    groups: tuple = ()

    def with_spec(self, spec) -> "Layout":
        return Layout(tuple(spec), self.groups)

    def index(self, dim: int, coords: dict, sizes: dict) -> tuple[int, int]:
        """(this rank's shard index, shard count) along ``dim``: the
        row-major index of its coordinates on the dim's axes."""
        idx, n = 0, 1
        for a in _axes(self.spec[dim] if dim < len(self.spec) else None):
            idx, n = idx * sizes[a] + coords[a], n * sizes[a]
        return idx, n

    def cut(self, x, coords: dict, sizes: dict):
        """The shard of the global ``x`` at mesh ``coords`` (a view)."""
        K = dict(self.groups)
        for d in range(x.dim()):
            i, n = self.index(d, coords, sizes)
            if n == 1:
                continue
            if d in K:
                g = x.unflatten(d, (x.shape[d] // K[d], K[d]))
                x = g.narrow(d + 1, i * K[d] // n, K[d] // n).flatten(d,
                                                                     d + 1)
            else:
                m = x.shape[d] // n
                x = x.narrow(d, i * m, m)
        return x


def gather_global(x, layout: Layout, tm, to_root: bool = False):
    """The global tensor of every rank's shard ``x`` (``layout.cut``'s
    inverse) over ``tm``, a ``collectives.TrainMesh``: exact gathers
    along each sharded dim, the inner axis of a tuple entry first, on
    every rank; with ``to_root`` on the host of the mesh's rank (0, 0)
    only (None elsewhere: a rank leaves after its shard reached its
    group's rank 0)."""
    K = dict(layout.groups)
    for d, entry in enumerate(layout.spec):
        for a in reversed(_axes(entry)):
            g = tm.group(a)
            if g.size == 1:
                continue
            kl = K[d] // g.size if d in K else None
            if kl is not None:
                # this shard's heads as (G, K / size): gather the kv part
                x = x.unflatten(d, (x.shape[d] // kl, kl))
            dd = d + 1 if kl is not None else d
            x = g.gather_to_root(x, dd) if to_root else g.gather(x, dd)
            if x is None:
                return None
            if kl is not None:
                x = x.flatten(d, d + 1)
    if to_root:
        return x.cpu() if all(c == 0 for c in tm.coords.values()) else None
    return x


def head_groups(cfg: ModelConfig, logical: tuple, spec: tuple,
                mesh) -> tuple:
    """((dim, K),) for the "heads" dims of a leaf that "model" alone
    shards while its size also divides K (the kv-head-group cut), else
    ()."""
    tp = mesh_shape(mesh).get("model", 1)
    return tuple((d, cfg.num_kv_heads)
                 for d, (name, entry) in enumerate(zip(logical, spec))
                 if name == "heads" and entry == "model"
                 and cfg.num_kv_heads % tp == 0)


def tree_layouts(params, specs, cfg: ModelConfig, rules: Rules, mesh):
    """The ``Layout`` of every leaf of ``params`` (tensors or shapes) on
    ``mesh`` from its logical ``specs``."""
    return map_specs(
        lambda logical, spec: Layout(spec, head_groups(cfg, logical, spec,
                                                       mesh)),
        specs, tree_pspecs(params, specs, rules, mesh))


def serving_rules(cfg: ModelConfig, pcfg: ParallelConfig, tp: int) -> Rules:
    """``make_rules`` for serving with sharded weights on a "model" axis
    of ``tp`` ranks, the MoE leaves in the cut their block's mode reads:
    experts over "model" where it runs "ep_*", the expert d_ff over
    "model" (with ``expert_ff_2d``: over ("data", "model")) where it runs
    "tp"."""
    from repro_torch.models.moe import expert_cut
    rules = make_rules(cfg, pcfg)
    if cfg.moe is not None:
        f2d = pcfg.expert_ff_2d
        if expert_cut(cfg, tp, f2d) == "experts":
            rules.update(experts="model", expert_ff=None)
        else:
            rules.update(experts=None,
                         expert_ff=("data", "model") if f2d else "model")
    return rules


def serving_layouts(cfg: ModelConfig, pcfg: ParallelConfig, mesh):
    """The ``Layout`` of every leaf of ``models.api.init_model``'s tree
    for a serving engine with sharded weights on ``mesh``."""
    from repro_torch.models.api import param_shapes, param_specs
    rules = serving_rules(cfg, pcfg, serving_tp(mesh))
    return tree_layouts(param_shapes(cfg), param_specs(cfg), cfg, rules,
                        mesh)


def cut_tree(params, layouts, coords: dict, sizes: dict):
    """Each leaf's shard at mesh ``coords`` (``Layout.cut``), a copy of
    its own bytes only (a leaf it leaves whole is itself), so that the
    whole leaves can be freed."""
    def one(x, lay):
        y = lay.cut(x, coords, sizes)
        return x if y is x else y.clone(memory_format=torch.contiguous_format)
    return map_specs(one, params, layouts)

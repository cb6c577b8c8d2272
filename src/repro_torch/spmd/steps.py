"""The train step (port of ``repro.spmd.steps.make_train_step`` and
``_split_microbatches``), its placement on a ("data", "model") mesh, and
the static path's prefill and decode steps.

With no mesh the step runs on one device (``zero1`` shards nothing there).
On a ``launch.mesh.make_host_mesh`` mesh (one process a rank, on
``torch.distributed``) it is the JAX package's step under its shardings
(``resolve_param_shardings``, ``opt_state_shardings``,
``batch_shardings``), with the collectives GSPMD would place run by hand:

- every family trains data parallel: the model is replicated over "data",
  each rank takes its rows of the global batch (``sharding.batch_spec``)
  and the gradients and metrics are averaged over "data", in fp32 (the
  bf16 gradients summed in fp32 in rank order, then divided);
- the dense decoders (``cfg.family == "dense"``: glm4, qwen3, starcoder2,
  gemma2) also train tensor parallel over "model" (Megatron-style
  column / row parallel attention and MLP, the vocab-parallel embedding
  and loss: ``models.attention``, ``models.layers``,
  ``models.embedding``); the other families are refused there by name;
- ZeRO-1 (``pcfg.zero1``, the default): the fp32 masters and slots are
  sharded over "data" (``zero``), the gradients reduce-scattered to each
  rank's slice, each rank updates its slice, and the bf16 casts are
  all-gathered into the working params. Without it every data rank
  holds whole masters and slots and the averaged gradient.

Layouts (``param_layouts``, ``state_layouts``) are computed from
``models.api.param_specs`` and ``sharding.make_rules``; ``shard_state``
cuts a rank's shards from the global tree. ``fsdp`` and
``seq_shard_activations`` are refused by name before anything runs.
"""

from __future__ import annotations

import torch

from repro_torch.config import ModelConfig, OptimizerConfig, ParallelConfig
from repro_torch.models import api, transformer
from repro_torch.optim import optimizers as opt
from repro_torch.spmd import collectives
from repro_torch.spmd import sharding as shd
from repro_torch.spmd import zero


def check_train_config(cfg: ModelConfig, pcfg: ParallelConfig,
                       ocfg: OptimizerConfig, mesh=None) -> None:
    """Raise on what the trainer cannot mean, naming ROADMAP: the options
    not ported (``fsdp``, ``seq_shard_activations``), tensor parallelism
    of a family other than the dense decoders (the MoE, SSM, hybrid,
    encoder-decoder and VLM families train data parallel), then an
    unknown remat mode (``transformer.check_trainable``)."""
    refused = {"fsdp": pcfg.fsdp,
               "seq_shard_activations": pcfg.seq_shard_activations}
    for what, on in refused.items():
        if on:
            raise NotImplementedError(
                f"{what}: not ported to the trainer (ROADMAP.md queue 1 "
                "item 12)")
    if ocfg.compression != "none":
        raise NotImplementedError(
            f"compression={ocfg.compression!r}: the JAX package's trainer "
            "never reads ocfg.compression; the int8 error-feedback "
            "all-reduce is a function, spmd.compression.compressed_psum_mean "
            "(ROADMAP.md queue 1 item 12)")
    tp = shd.mesh_shape(mesh).get("model", 1)
    if tp > 1 and cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: tensor-parallel training (model={tp}) of the "
            f"{cfg.family} family is not ported, only of the dense decoders "
            "(the MoE, SSM, hybrid, encoder-decoder and VLM families train "
            "data parallel; ROADMAP.md queue 1 item 12)")
    transformer.check_trainable(cfg, pcfg)


_BATCH_AXIS = {"positions": 1}   # (3, B, S) M-RoPE ids; the rest dim 0


def _split_microbatches(batch: dict, m: int) -> list[dict]:
    """m microbatches of ``batch``, microbatch i holding the i-th run of
    B/m consecutive rows of every entry: on dim 1 for the (3, B, S) M-RoPE
    ``positions``, on dim 0 for the rest. As in the JAX package every
    entry splits, ``sampled_ids`` too."""
    def split(name, x):
        ax = _BATCH_AXIS.get(name, 0)
        if x.shape[ax] % m:
            raise ValueError(f"{name}: batch {x.shape[ax]} is not a "
                             f"multiple of {m} microbatches")
        return x.chunk(m, dim=ax)
    parts = {k: split(k, v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(m)]


def param_layouts(cfg: ModelConfig, pcfg: ParallelConfig, mesh):
    """The ``sharding.Layout`` of every working param on ``mesh``."""
    return shd.tree_layouts(api.param_shapes(cfg), api.param_specs(cfg), cfg,
                            shd.make_rules(cfg, pcfg), mesh)


def state_layouts(cfg: ModelConfig, pcfg: ParallelConfig, mesh,
                  zero1: bool | None = None):
    """The layout of every master (and of the slot leaves that mirror it):
    the param's, with ZeRO-1's "data" entry when ``zero1`` (default
    ``pcfg.zero1``)."""
    zero1 = pcfg.zero1 if zero1 is None else zero1
    fn = zero.zero1_state_layouts if zero1 else zero.plain_state_layouts
    return fn(api.param_shapes(cfg), param_layouts(cfg, pcfg, mesh), mesh)


def train_layouts(cfg: ModelConfig, pcfg: ParallelConfig, ocfg, mesh):
    """{"params": param layouts, "opt": {name: state layouts}} shaped like
    the trainer's {"params", "opt"} state (``opt.init_train_state``'s
    keys)."""
    sl = state_layouts(cfg, pcfg, mesh)
    slots = opt.init_opt_state(ocfg, {})
    return {"params": param_layouts(cfg, pcfg, mesh),
            "opt": {"master": sl, **{k: sl for k in slots}}}


def shard_state(tree, layouts, mesh):
    """This rank's shards (contiguous copies) of the global ``tree``."""
    tm = collectives.train_mesh(mesh)
    return shd.map_specs(
        lambda x, lay: lay.cut(x, tm.coords, tm.shape).contiguous().clone(),
        tree, layouts)


def gather_state(tree, layouts, mesh):
    """The global tree of every rank's shards (``shard_state``'s inverse),
    on every rank."""
    tm = collectives.train_mesh(mesh)
    return shd.map_specs(lambda x, lay: shd.gather_global(x, lay, tm),
                         tree, layouts)


def batch_rows(batch: dict, mesh) -> dict:
    """This data rank's rows of a global batch (dim 1 of the (3, B, S)
    M-RoPE ``positions``, dim 0 of the rest), as ``sharding.batch_spec``
    places them: the whole batch where the data size does not divide
    it."""
    tm = collectives.train_mesh(mesh)
    dp, r = tm.shape["data"], tm.coords["data"]

    def rows(name, x):
        ax = _BATCH_AXIS.get(name, 0)
        if shd.batch_spec(x.shape[ax], tm.shape, 0)[0] is None:
            return x
        n = x.shape[ax] // dp
        return x.narrow(ax, r * n, n)
    return {k: rows(k, v) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, pcfg: ParallelConfig,
                    ocfg: OptimizerConfig, mesh=None):
    """Returns ``train_step(params, opt_state, step, batch, grad_hook=None)
    -> (params, opt_state, metrics)``: params are the bf16 working copy
    (leaves that require a gradient), opt_state holds the fp32 masters and
    slots; both are updated in place. Gradients are taken with respect to
    the working params; with ``microbatches > 1`` they accumulate in fp32,
    each divided by m, and the loss and metrics are averaged. Then clip,
    update, and metrics {loss, grad_norm, lr, ce, aux}. ``grad_hook``, if
    given, sees the gradient tree before clipping.

    With ``mesh`` (every rank of it calls the step, in step): params and
    opt_state are this rank's shards (``shard_state`` of
    ``train_layouts``), ``batch`` is the global batch (each rank keeps its
    rows), the gradients ``grad_hook`` sees are averaged over "data" (a
    ZeRO-1 leaf: this rank's slice), and the metrics are the mesh's, the
    same bits on every rank."""
    check_train_config(cfg, pcfg, ocfg, mesh)
    m = pcfg.microbatches
    tm = collectives.train_mesh(mesh) if mesh is not None else None
    if tm is not None:
        plan = _MeshPlan(cfg, pcfg, mesh, tm)

    def value_and_grads(params, mb):
        mb = dict(mb)
        sampled = mb.pop("sampled_ids", None)
        loss, metr = api.loss_fn(params, mb, cfg, pcfg, sampled_ids=sampled)
        leaves = opt.tree_leaves(params)
        grads = iter(torch.autograd.grad(loss, leaves))
        return (loss.detach(), {k: v.detach() for k, v in metr.items()},
                opt.tree_map(lambda _: next(grads), params))

    def grads_of(params, batch):
        if m <= 1:
            return value_and_grads(params, batch)
        gacc = opt.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params)
        loss, metrics = 0.0, []
        for mb in _split_microbatches(batch, m):
            lval, metr, g = value_and_grads(params, mb)
            for a, b in zip(opt.tree_leaves(gacc), opt.tree_leaves(g)):
                a.add_(b.float() / m)
            loss = loss + lval / m
            metrics.append(metr)
            del g
        metr = {k: torch.stack([x[k] for x in metrics]).mean()
                for k in metrics[0]}
        return loss, metr, gacc

    def train_step(params, opt_state, step, batch, grad_hook=None):
        if tm is None:
            loss, metr, grads = grads_of(params, batch)
        else:
            with collectives.use_train(tm):
                loss, metr, grads = grads_of(params, batch_rows(batch, mesh))
            loss, metr = plan.mean_metrics(loss, metr)
            grads = plan.average(grads)
        if grad_hook is not None:
            grad_hook(grads)
        kw = {} if tm is None else plan.norm_args(grads)
        if ocfg.grad_clip:
            grads, gnorm = opt.clip_by_global_norm(grads, ocfg.grad_clip,
                                                   **kw)
        else:
            gnorm = opt.global_norm(kw.get("pieces", grads), kw.get("stitch"))
        if tm is None:
            params, opt_state = opt.apply_updates_master(
                ocfg, opt_state, grads, step, params)
        else:
            plan.update(ocfg, params, opt_state, grads, step)
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "lr": opt.schedule(ocfg, step), **metr}
        return params, opt_state, metrics

    return train_step


def _replace_leaves(tree, fn) -> None:
    """Replace every leaf x of a tree of dicts and lists by fn(x), in
    place, in ``opt.tree_leaves`` order."""
    keys = tree.keys() if isinstance(tree, dict) else range(len(tree))
    for k in keys:
        if isinstance(tree[k], (dict, list)):
            _replace_leaves(tree[k], fn)
        else:
            tree[k] = fn(tree[k])


class _MeshPlan:
    """The collectives of one rank's train step on a mesh, per leaf in
    ``opt.tree_leaves`` order: the "data" dim of its ZeRO-1 slice (or
    None), whether the state is sliced there, and over which axes its
    gradient piece is sharded for the norm."""

    def __init__(self, cfg, pcfg, mesh, tm):
        self.tm = tm
        lay0 = opt.tree_leaves(param_layouts(cfg, pcfg, mesh))
        zlay = opt.tree_leaves(state_layouts(cfg, pcfg, mesh, zero1=True))
        self.zdims = [zero.zero_dim(lay) for lay in zlay]
        self.sliced = pcfg.zero1
        dp, tp = tm.shape["data"], tm.shape["model"]
        # (dp, tp, L) 0/1: the ranks whose piece of leaf l the norm adds.
        # The pieces are each leaf's ZeRO-1 slices whether or not the
        # state is sliced, so the norm (and the clip scale) is the same
        # bits either way; a replicated piece counts once.
        mask = torch.zeros((dp, tp, len(lay0)))
        for i, (lay, z) in enumerate(zip(lay0, self.zdims)):
            on_model = any(e is not None for e in lay.spec)
            mask[:dp if z is not None else 1, :tp if on_model else 1, i] = 1
        self.mask = mask

    def mean_metrics(self, loss, metr):
        """The loss and metrics averaged over "data" (one collective)."""
        if self.tm.data.size == 1:
            return loss, metr
        keys = list(metr)
        v = self.tm.data.all_reduce(
            torch.stack([loss.float()] + [metr[k].float() for k in keys]),
            mean=True)
        return v[0], {k: v[i + 1] for i, k in enumerate(keys)}

    def average(self, grads):
        """The gradients averaged over "data" in fp32: a ZeRO-1 leaf's
        slice (reduce-scatter), a whole leaf otherwise (all-reduce). The
        tree's leaves are replaced one at a time, in place, so each bf16
        gradient is freed as its average arrives."""
        dg = self.tm.data
        if dg.size == 1:
            return grads
        zdims = iter(self.zdims)

        def avg(g):
            z = next(zdims)
            if self.sliced and z is not None:
                return dg.reduce_scatter(g, z, mean=True).contiguous()
            return dg.all_reduce(g, mean=True, dtype=torch.float32)
        _replace_leaves(grads, avg)
        return grads

    def norm_args(self, grads) -> dict:
        """``clip_by_global_norm``'s ``stitch`` and ``pieces``: this
        rank's ZeRO-1 slice of each leaf (cut here when the state is not
        sliced) and the sum of every rank's sums of squares by ``mask``."""
        dg = self.tm.data
        pieces = grads
        if not self.sliced and dg.size > 1:
            pieces = [g if z is None else
                      g.chunk(dg.size, dim=z)[dg.rank].contiguous()
                      for g, z in zip(opt.tree_leaves(grads), self.zdims)]

        def stitch(sq):
            allm = self.tm.model.gather(sq[None], 0)        # (tp, L)
            full = self.tm.data.gather(allm[None], 0)       # (dp, tp, L)
            return (full * self.mask.to(full.device)).sum(dim=(0, 1)).sum()
        return {"stitch": stitch, "pieces": pieces}

    @torch.no_grad()
    def update(self, ocfg, params, state, grads, step):
        """The optimizer update of this rank's masters and slots (its
        ZeRO-1 slices), then their bf16 casts into the working params
        (gathered over "data" from the slices)."""
        slots = {k: v for k, v in state.items() if k != "master"}
        opt.apply_updates(ocfg, state["master"], grads, slots, step)
        dg = self.tm.data
        for w, p, z in zip(opt.tree_leaves(params),
                           opt.tree_leaves(state["master"]), self.zdims):
            if self.sliced and z is not None and dg.size > 1:
                w.copy_(dg.gather(p.to(w.dtype), z))
            else:
                w.copy_(p)


def make_prefill_step(cfg: ModelConfig):
    """``prefill_step(params, batch) -> (cache, next_token)``."""
    def prefill_step(params, batch):
        return api.prefill_fn(params, batch, cfg)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """``decode_step(params, cache, batch) -> (next_token, cache)``."""
    def decode_step(params, cache, batch):
        return api.decode_fn(params, cache, batch, cfg)
    return decode_step

"""The train step (port of ``repro.spmd.steps.make_train_step`` and
``_split_microbatches``) and the static path's prefill and decode steps.

One device and no mesh: the JAX package's sharding assignments
(``batch_shardings``, ``param_shardings``, ZeRO-1 state shardings) wait for
tensor parallelism (ROADMAP.md queue 1 item 12). ``zero1`` shards nothing
on one device and is a no-op; the options that have no one-device meaning
are refused by name before anything runs.
"""

from __future__ import annotations

import torch

from repro_torch.config import ModelConfig, OptimizerConfig, ParallelConfig
from repro_torch.models import api, transformer
from repro_torch.optim import optimizers as opt


def check_train_config(cfg: ModelConfig, pcfg: ParallelConfig,
                       ocfg: OptimizerConfig) -> None:
    """Raise on what the one-device trainer cannot mean, naming ROADMAP:
    the multi-device options, then an unknown remat mode
    (``transformer.check_trainable``)."""
    refused = {"fsdp": pcfg.fsdp,
               "seq_shard_activations": pcfg.seq_shard_activations,
               f"compression={ocfg.compression!r}": ocfg.compression != "none"}
    for what, on in refused.items():
        if on:
            raise NotImplementedError(
                f"{what}: not ported to the one-device trainer (ROADMAP.md "
                "queue 1 item 12)")
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


def make_train_step(cfg: ModelConfig, pcfg: ParallelConfig,
                    ocfg: OptimizerConfig):
    """Returns ``train_step(params, opt_state, step, batch, grad_hook=None)
    -> (params, opt_state, metrics)``: params are the bf16 working copy
    (leaves that require a gradient), opt_state holds the fp32 masters and
    slots; both are updated in place. Gradients are taken with respect to
    the working params; with ``microbatches > 1`` they accumulate in fp32,
    each divided by m, and the loss and metrics are averaged. Then clip,
    update, and metrics {loss, grad_norm, lr, ce, aux}. ``grad_hook``, if
    given, sees the gradient tree before clipping."""
    check_train_config(cfg, pcfg, ocfg)
    m = pcfg.microbatches

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
        loss, metr, grads = grads_of(params, batch)
        if grad_hook is not None:
            grad_hook(grads)
        if ocfg.grad_clip:
            grads, gnorm = opt.clip_by_global_norm(grads, ocfg.grad_clip)
        else:
            gnorm = opt.global_norm(grads)
        params, opt_state = opt.apply_updates_master(ocfg, opt_state, grads,
                                                     step, params)
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "lr": opt.schedule(ocfg, step), **metr}
        return params, opt_state, metrics

    return train_step


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

"""Optimizers as user-level tensor code (port of
``repro.optim.optimizers``, paper §4.1): SGD, Momentum, Adagrad, RMSProp,
Adadelta, Adam and AdamW as plain functions over (param, grad, slots).

Trees are the port's parameter layout: nested dicts and lists of tensors.
Every slot tree mirrors the parameters. The math runs in fp32 on fp32
masters with the JAX package's op order; moments are stored back at the
slot dtype. Unlike the JAX package, which returns new trees, the updates
write the new values into the given master and slot tensors in place, one
leaf at a time, so a step needs one leaf's temporaries and not a second
copy of the state (46 GB for 8 layers of glm4_9b at full width).
"""

from __future__ import annotations

import math

import torch

from repro_torch.config import OptimizerConfig

_SLOT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def tree_leaves(tree) -> list:
    """Leaves of a tree of dicts and lists, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of the
    trees in ``rest``; the result has ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def slot_dtype(ocfg: OptimizerConfig) -> torch.dtype:
    return _SLOT_DTYPES[ocfg.slot_dtype]


def init_opt_state(ocfg: OptimizerConfig, params) -> dict:
    """Zero slots mirroring ``params``: none for sgd, ``s0`` for momentum,
    adagrad and rmsprop, ``s0`` and ``s1`` for adadelta, adam and adamw."""
    n = {"sgd": 0, "momentum": 1, "adagrad": 1, "rmsprop": 1, "adadelta": 2,
         "adam": 2, "adamw": 2}.get(ocfg.name)
    if n is None:
        raise ValueError(f"unknown optimizer {ocfg.name!r}")
    sd = slot_dtype(ocfg)
    return {f"s{i}": tree_map(lambda p: torch.zeros_like(p, dtype=sd),
                              params) for i in range(n)}


def init_train_state(ocfg: OptimizerConfig, params_f32) -> dict:
    """Mixed-precision training state: the fp32 masters live inside the
    optimizer state; the working params handed to forward and backward are
    bf16 casts (``working_params``)."""
    return {"master": params_f32, **init_opt_state(ocfg, params_f32)}


def working_params(state: dict):
    """bf16 casts of the masters, leaves that require a gradient."""
    return tree_map(lambda p: p.detach().to(torch.bfloat16).requires_grad_(),
                    state["master"])


def schedule(ocfg: OptimizerConfig, step) -> torch.Tensor:
    """Learning rate at ``step``: fp32 0-d tensor, with the JAX package's
    fp32 rounding (warmup, then constant, linear or cosine decay)."""
    s = torch.tensor(float(step), dtype=torch.float32)
    warm = (torch.clamp((s + 1.0) / ocfg.warmup_steps, max=1.0)
            if ocfg.warmup_steps > 0 else 1.0)
    if ocfg.schedule == "constant":
        dec = 1.0
    elif ocfg.schedule == "linear":
        dec = torch.clamp(1.0 - s / ocfg.total_steps, min=0.0)
    else:  # cosine
        t = torch.clamp(s / ocfg.total_steps, 0.0, 1.0)
        dec = 0.5 * (1.0 + torch.cos(math.pi * t))
    return torch.as_tensor(ocfg.lr * warm * dec, dtype=torch.float32)


def global_norm(tree, stitch=None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares.
    Sharded leaves (multi-rank training): ``stitch`` takes this rank's
    (L,) fp32 sums of squares of its pieces and returns the total over
    the mesh, each piece counted once (``spmd.steps`` sums a sharded leaf
    over the axes it is sharded on and counts a replicated one once, with
    the same bits on every rank)."""
    if stitch is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                              for x in tree_leaves(tree)))
    return torch.sqrt(stitch(torch.stack(
        [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)])))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, stitch=None, pieces=None):
    """Scale every leaf by min(1, max_norm / norm), the scale cast to the
    leaf's dtype, in place. Returns (grads, norm before clipping). With
    ``stitch``, the norm of the sharded gradient: ``pieces`` (default the
    gradient) are the tensors whose sums of squares ``stitch`` adds up
    (``global_norm``)."""
    gn = global_norm(grads if pieces is None else pieces, stitch)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    for g in tree_leaves(grads):
        g.mul_(scale.to(g.dtype))
    return grads, gn


def _leaf_update(ocfg, lr, c1, c2, p, g, slots):
    """New (param, slots) of one fp32 leaf for the gradient ``g`` (fp32):
    the JAX package's formulas, term for term."""
    name = ocfg.name
    b1, b2, eps = ocfg.beta1, ocfg.beta2, ocfg.eps
    if name == "sgd":
        return p - lr * g, ()
    if name == "momentum":
        v = b1 * slots[0] + g
        return p - lr * v, (v,)
    if name == "adagrad":
        a = slots[0] + g * g
        return p - lr * g / (torch.sqrt(a) + eps), (a,)
    if name == "rmsprop":
        a = b2 * slots[0] + (1 - b2) * g * g
        return p - lr * g / (torch.sqrt(a) + eps), (a,)
    if name == "adadelta":
        rho = b2
        acc_g = rho * slots[0] + (1 - rho) * g * g
        upd = g * torch.sqrt(slots[1] + eps) / torch.sqrt(acc_g + eps)
        acc_x = rho * slots[1] + (1 - rho) * upd * upd
        return p - lr * upd, (acc_g, acc_x)
    if name in ("adam", "adamw"):
        m, v = slots
        m = (b1 * m.float() + (1 - b1) * g).to(m.dtype)
        v = (b2 * v.float() + (1 - b2) * g * g).to(v.dtype)
        u = (m.float() / c1) / (torch.sqrt(v.float() / c2) + eps)
        if name == "adamw" and ocfg.weight_decay:
            u = u + ocfg.weight_decay * p
        return p - lr * u, (m, v)
    raise ValueError(name)


@torch.no_grad()
def apply_updates(ocfg: OptimizerConfig, params, grads, state: dict, step):
    """One optimizer step, all math in fp32 (params are fp32 masters).
    Writes the new params and slots into ``params`` and ``state`` in place
    and returns them."""
    lr = float(schedule(ocfg, step))
    t = torch.tensor(float(step) + 1.0, dtype=torch.float32)
    c1 = float(1.0 - torch.tensor(ocfg.beta1, dtype=torch.float32) ** t)
    c2 = float(1.0 - torch.tensor(ocfg.beta2, dtype=torch.float32) ** t)
    names = sorted(state)
    slot_leaves = [tree_leaves(state[n]) for n in names]
    for i, (p, g) in enumerate(zip(tree_leaves(params), tree_leaves(grads))):
        slots = tuple(sl[i] for sl in slot_leaves)
        new_p, new_slots = _leaf_update(ocfg, lr, c1, c2, p, g.float(),
                                        slots)
        p.copy_(new_p)
        for s, ns in zip(slots, new_slots):
            s.copy_(ns)
    return params, state


def apply_updates_master(ocfg: OptimizerConfig, state: dict, grads, step,
                         params):
    """Update the fp32 masters and slots in ``state`` in place from
    ``grads`` (any float dtype, taken to fp32 one leaf at a time), then
    write the masters' casts into the working ``params`` in place.
    Returns (params, state)."""
    slots = {k: v for k, v in state.items() if k != "master"}
    apply_updates(ocfg, state["master"], grads, slots, step)
    with torch.no_grad():
        for w, p in zip(tree_leaves(params), tree_leaves(state["master"])):
            w.copy_(p)
    return params, state

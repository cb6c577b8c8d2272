"""Shared cases for the port's training tests against the JAX package at
smoke size (``tests/test_torch_train_*.py``): the same fp32 masters (the
port's ``init_model`` with seed 0, in the JAX package's layout through
``jax_layout``; ``params_from_jax`` carries them back) and the same
``make_batch`` batch (B 2, S 16; frames for whisper, 3-plane positions
for qwen2_vl) through the JAX package's ``loss_fn`` / ``make_train_step``
and the port's.

Tolerances, the port's ladder: with bf16 activations loss, ce and aux
within 1e-2 and the grad norm within 1e-2 relative (the two frameworks
round bf16 activations at other places). The masters are held (for the
SSM families) after an SGD step at fp32 activations (SGD's update is the gradient itself, where
AdamW's first step is about lr * sign(g) and would turn a sign flip of a
near-zero gradient element into a whole update): every fp32 master
within 1e-2 of the largest update, the bf16 rung, since the working
params and so their gradients are bf16 (a one-ulp flip of a gradient
element near the largest moves its update by 2^-8 of it; measured up to
3e-3 at these sizes)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.config import OptimizerConfig as JOpt
from repro.config import ParallelConfig as JPar
from repro.config import ShapeConfig as JShape
from repro.config import get_config as jax_get_config
from repro.models import api as japi
from repro.optim import optimizers as jopt
from repro.spmd import steps as jsteps
from repro_torch.config import (OptimizerConfig, ParallelConfig, ShapeConfig,
                                get_config)
from repro_torch.models import api
from repro_torch.models.transformer import period_structure
from repro_torch.optim import optimizers as topt
from repro_torch.spmd import steps as tsteps

B, S = 2, 16
ADAMW = dict(lr=1e-3, warmup_steps=1, total_steps=10)
SGD = dict(name="sgd", lr=0.5, warmup_steps=0, schedule="constant")
FULL_MB2 = dict(remat="full", microbatches=2)


def make_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def jax_layout(tree, cfg):
    """The port's parameter tree as numpy in the JAX package's layout:
    layer ``p * P + i`` stacked into ``blocks/sub{i}`` at ``p`` (P kinds a
    period), the hybrid's ``shared`` block as it is, an encoder-decoder's
    ``encoder`` and ``decoder`` lists stacked (``params_from_jax``'s
    inverse)."""
    def leaves(t):
        return topt.tree_map(lambda x: x.detach().numpy(), t)

    def stack(layers):
        return topt.tree_map(lambda *xs: np.stack(xs), *map(leaves, layers))

    out = {k: leaves(v) for k, v in tree.items()
           if k not in ("layers", "encoder", "decoder")}
    if cfg.encoder_layers:
        out.update(encoder=stack(tree["encoder"]),
                   decoder=stack(tree["decoder"]))
        return out
    P = len(period_structure(cfg)[0])
    out["blocks"] = {f"sub{i}": stack(tree["layers"][i::P]) for i in range(P)}
    return out


def cases(archs, dtypes=("bfloat16", "float32")):
    """{(arch, dtype): Case}, one JAX init per arch."""
    mesh, out = make_mesh(), {}
    for arch in archs:
        first = Case(mesh, arch, dtypes[0])
        out[arch, dtypes[0]] = first
        for d in dtypes[1:]:
            out[arch, d] = first.at(d)
    return out


class Case:
    """One arch at one activation dtype: both configs, the fp32 masters as
    numpy in the JAX package's layout (drawn once: they do not depend on
    the dtype; pass ``masters`` to share them), and the batch (numpy for
    the JAX side, tensors for the port)."""

    def __init__(self, mesh, arch, dtype="bfloat16", masters=None):
        self.mesh, self.arch = mesh, arch
        self.jcfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                                        dtype=dtype)
        self.tcfg = dataclasses.replace(get_config(arch, smoke=True),
                                        dtype=dtype)
        if masters is None:
            masters = jax_layout(api.init_model(self.tcfg, 0, "cpu",
                                                torch.float32), self.tcfg)
        self.masters = masters
        self.jbatch = japi.make_batch(self.jcfg, JShape("t", S, B, "train"))
        self.tbatch = api.make_batch(self.tcfg, ShapeConfig("t", S, B,
                                                            "train"),
                                     0, "cpu")
        if dtype == "float32" and "frames" in self.tbatch:
            # the frames set the dtype of both encoders' residual stream:
            # bf16 frames run the encoder in bf16 at any cfg.dtype, whose
            # rounding moves the encoder's leaves by about 1% of their
            # update; at fp32 every leaf agrees to about 1e-3
            self.jbatch["frames"] = self.jbatch["frames"].astype(jnp.float32)
            self.tbatch["frames"] = self.tbatch["frames"].float()

    def at(self, dtype):
        """This arch at another activation dtype, on the same masters."""
        return Case(self.mesh, self.arch, dtype, self.masters)

    def jax_loss(self, remat="none"):
        pcfg = JPar(remat=remat)
        with jax.set_mesh(self.mesh):
            loss, m = jax.jit(lambda p, b: japi.loss_fn(
                p, b, self.jcfg, pcfg))(jax.tree.map(
                    lambda x: jnp.asarray(x, jnp.bfloat16), self.masters),
                    self.jbatch)
        return {"loss": float(loss), **{k: float(v) for k, v in m.items()}}

    def port_loss(self, remat="none"):
        params = topt.tree_map(lambda t: t.to(torch.bfloat16),
                               api.params_from_jax(self.masters, self.tcfg,
                                                   "cpu"))
        loss, m = api.loss_fn(params, self.tbatch, self.tcfg,
                              ParallelConfig(remat=remat))
        return {"loss": float(loss), **{k: float(v) for k, v in m.items()}}

    def jax_step(self, pkw, okw):
        ocfg = JOpt(**okw)
        step = jax.jit(jsteps.make_train_step(self.jcfg, JPar(**pkw), ocfg))
        with jax.set_mesh(self.mesh):
            state = jopt.init_train_state(ocfg, jax.tree.map(jnp.asarray,
                                                             self.masters))
            params = jax.tree.map(lambda x: x.astype(jnp.bfloat16),
                                  state["master"])
            _, state, m = step(params, state, jnp.asarray(1, jnp.int32),
                               self.jbatch)
        return ({k: float(v) for k, v in m.items()},
                jax.tree.map(np.asarray, state["master"]))

    def port_step(self, pkw, okw):
        ocfg = OptimizerConfig(**okw)
        state = topt.init_train_state(ocfg, api.params_from_jax(
            self.masters, self.tcfg, "cpu"))
        step = tsteps.make_train_step(self.tcfg, ParallelConfig(**pkw), ocfg)
        _, state, m = step(topt.working_params(state), state, 1, self.tbatch)
        return {k: float(v) for k, v in m.items()}, state["master"]


def leaf_names(tree, prefix=""):
    """Paths of ``tree``'s leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items()
                for n in leaf_names(v, f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in leaf_names(v, f"{prefix}/{i}")]
    return [prefix]


def close_metrics(t: dict, j: dict, keys=("loss", "ce", "aux")):
    """Loss, ce and aux within 1e-2, the grad norm (where given) within
    1e-2 relative, the learning rate equal."""
    for k in keys:
        assert abs(t[k] - j[k]) <= 1e-2, (k, t, j)
    if "grad_norm" in j:
        assert abs(t["grad_norm"] - j["grad_norm"]) <= 1e-2 * j["grad_norm"]
        assert t["lr"] == j["lr"]


def check_loss_fn(case: Case):
    """The port's loss_fn on the bf16 cast of the masters: loss, ce and
    aux within 1e-2 of the JAX package's (aux > 0 exactly for MoE)."""
    t, j = case.port_loss(), case.jax_loss()
    close_metrics(t, j)
    assert (t["aux"] > 0) == (case.tcfg.moe is not None)


def check_train_step(case: Case, pkw=FULL_MB2):
    """One AdamW step (bf16 working params, fp32 masters): loss, ce, aux
    and grad norm as ``close_metrics``."""
    (t, _), (j, _) = case.port_step(pkw, ADAMW), case.jax_step(pkw, ADAMW)
    assert set(t) == set(j) == {"loss", "grad_norm", "lr", "ce", "aux"}
    close_metrics(t, j)


def check_sgd_masters(case: Case):
    """One SGD step at fp32 activations, remat full, two microbatches:
    the metrics as above, every master within 1e-2 of the largest
    update, and each leaf on its own within 1e-2 of its own update (L2
    norms), so that a small leaf (a router, A_log, dt_bias, D, a conv
    weight) is held as tightly as the embedding table. The JAX result is
    carried into the port's layout by ``params_from_jax``."""
    (t, tm), (j, jm) = case.port_step(FULL_MB2, SGD), case.jax_step(
        FULL_MB2, SGD)
    close_metrics(t, j)
    # leaves matched by name (the JAX result's dicts come back key-sorted)
    def aligned(tree):
        return topt.tree_leaves(topt.tree_map(
            lambda _, x: x, tm, api.params_from_jax(tree, case.tcfg, "cpu")))
    want, init, got = aligned(jm), aligned(case.masters), topt.tree_leaves(tm)
    assert len(got) == len(want) == len(init)
    upd = max(float((a - b).abs().max()) for a, b in zip(want, init))
    assert upd > 0
    names = leaf_names(tm)
    for name, a, b, c in zip(names, got, want, init):
        assert float((a - b).abs().max()) <= 1e-2 * upd, name
        own = float((b - c).norm())
        assert own > 0, name
        assert float((a - b).norm()) <= 1e-2 * own, (
            name, float((a - b).norm()), own)

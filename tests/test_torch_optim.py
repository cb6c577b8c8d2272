"""The port's optimizers and training configs against the JAX package.

Every update rule, ``apply_updates_master``, ``schedule``,
``clip_by_global_norm`` and bf16 slots run on the same trees and gradients
(numpy, seeded) in both packages for three steps; fp32 results agree to
1e-6 relative to each tensor's largest magnitude (the same fp32 formulas;
XLA may fuse or reorder a product). The port updates in place, so it runs
on copies."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro.optim import optimizers as jopt
from repro_torch import config as tconfig
from repro_torch.optim import optimizers as topt
import torch_cpu  # noqa: F401  (one torch thread)

NAMES = ["sgd", "momentum", "adagrad", "rmsprop", "adadelta", "adam",
         "adamw"]
TOL = 1e-6


def _trees(seed, scale=1.0):
    """Keys in sorted order, so both packages list the leaves alike."""
    rng = np.random.default_rng(seed)
    return {"layers": [{"b": (scale * rng.normal(0, 1, (4,))).astype(
                np.float32)} for _ in range(2)],
            "w": (scale * rng.normal(0, 1, (5, 3))).astype(np.float32)}


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_torch(tree):
    return topt.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(t_tree, j_tree, tol=TOL):
    for a, b in zip(topt.tree_leaves(t_tree), jax.tree.leaves(j_tree)):
        a, b = a.float().numpy(), np.asarray(b, np.float32)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-30)


def _ocfgs(name, **kw):
    base = dict(name=name, lr=0.05, warmup_steps=2, schedule="cosine",
                total_steps=10, weight_decay=0.1, grad_clip=0.0)
    base.update(kw)
    return jconfig.OptimizerConfig(**base), tconfig.OptimizerConfig(**base)


@pytest.mark.parametrize("name", NAMES)
def test_optimizer_matches_jax(name):
    """Three steps of ``apply_updates`` from zero slots."""
    jcfg, tcfg = _ocfgs(name)
    params = _trees(0)
    jp, tp = _to_jax(params), _to_torch(params)
    js, ts = jopt.init_opt_state(jcfg, jp), topt.init_opt_state(tcfg, tp)
    assert sorted(js) == sorted(ts)
    for step in range(3):
        g = _trees(10 + step, 0.3)
        jp, js = jopt.apply_updates(jcfg, jp, _to_jax(g), js, step)
        tp, ts = topt.apply_updates(tcfg, tp, _to_torch(g), ts, step)
        _close(tp, jp)
        for k in js:
            _close(ts[k], js[k])


@pytest.mark.parametrize("name,slot_dtype", [
    ("adamw", "float32"), ("adamw", "bfloat16"), ("momentum", "float32")])
def test_apply_updates_master_matches_jax(name, slot_dtype):
    """fp32 masters with bf16 gradients; the bf16 working params equal the
    JAX package's bit for bit (the port writes them into the given tree). bf16 slots: adamw
    (the JAX package stores only adam's moments back at the slot dtype)."""
    jcfg, tcfg = _ocfgs(name, slot_dtype=slot_dtype)
    master = _trees(1)
    jstate = jopt.init_train_state(jcfg, _to_jax(master))
    tstate = topt.init_train_state(tcfg, _to_torch(master))
    work = topt.working_params(tstate)
    assert all(w.dtype == torch.bfloat16 and w.requires_grad
               for w in topt.tree_leaves(work))
    for step in range(3):
        g = _trees(20 + step, 0.3)
        jg = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), g)
        tg = topt.tree_map(lambda a: torch.from_numpy(a).bfloat16(), g)
        jw, jstate = jopt.apply_updates_master(jcfg, jstate, jg, step)
        work, tstate = topt.apply_updates_master(tcfg, tstate, tg, step,
                                                 work)
        for k in jstate:
            want = torch.float32 if k == "master" else topt.slot_dtype(tcfg)
            assert topt.tree_leaves(tstate[k])[0].dtype == want
            _close(tstate[k], jstate[k])
        for a, b in zip(topt.tree_leaves(work), jax.tree.leaves(jw)):
            np.testing.assert_array_equal(a.detach().float().numpy(),
                                          np.asarray(b, np.float32))


@pytest.mark.parametrize("sched", ["constant", "linear", "cosine"])
@pytest.mark.parametrize("warmup", [0, 5])
def test_schedule_matches_jax(sched, warmup):
    jcfg, tcfg = _ocfgs("adamw", schedule=sched, warmup_steps=warmup,
                        total_steps=20, lr=3e-4)
    for step in (0, 1, 4, 5, 10, 19, 25):
        a = topt.schedule(tcfg, step)
        assert a.dtype == torch.float32
        assert float(a) == float(jnp.float32(jopt.schedule(jcfg, step)))


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_by_global_norm_matches_jax(max_norm, dtype):
    g = _trees(5)
    jg = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), g)
    tg = topt.tree_map(lambda a: torch.from_numpy(a).to(
        getattr(torch, dtype)), g)
    jc, jn = jopt.clip_by_global_norm(jg, max_norm)
    tc, tn = topt.clip_by_global_norm(tg, max_norm)
    assert abs(float(tn) - float(jn)) <= TOL * float(jn)
    _close(tc, jc, tol=TOL if dtype == "float32" else 1e-2)
    for a in topt.tree_leaves(tc):
        assert a.dtype == getattr(torch, dtype)


@pytest.mark.parametrize("name", ["ShapeConfig", "ParallelConfig",
                                  "OptimizerConfig"])
def test_config_dataclasses_field_for_field(name):
    ours, ref = getattr(tconfig, name), getattr(jconfig, name)
    a, b = dataclasses.fields(ours), dataclasses.fields(ref)
    assert [(f.name, f.default) for f in a] == \
        [(f.name, f.default) for f in b]
    assert ours.__dataclass_params__.frozen


def test_unknown_optimizer_is_refused():
    _, tcfg = _ocfgs("lbfgs")
    with pytest.raises(ValueError, match="lbfgs"):
        topt.init_opt_state(tcfg, _to_torch(_trees(0)))

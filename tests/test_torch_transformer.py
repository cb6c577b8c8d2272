"""The port's dense serving forward against the JAX package at smoke size:
``params_from_jax`` round trip, then ``prefill_chunk_paged`` (two chunks)
and ``decode_step_paged`` (one active slot, one idle) on the same
parameters, tokens, block tables and page pools."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ParallelConfig, get_config as jax_get_config
from repro.models import api as japi
from repro.models import transformer as jtf
from repro.serving.kv_cache import init_paged_cache as jax_init_paged_cache
from repro_torch.config import get_config
from repro_torch.models import transformer as ttf
from repro_torch.models.api import init_model, params_from_jax
import torch_cpu  # noqa: F401  (one torch thread)

# fp32: the two frameworks sum in other orders; bf16: activations round at
# other places (XLA may keep fused intermediates in fp32), which moves
# logits of magnitude ~1 by up to a few bf16 ulps after two layers
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 5e-2}


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _setup(mesh, dtype):
    jcfg = dataclasses.replace(jax_get_config("glm4_9b", smoke=True),
                               dtype=dtype)
    tcfg = dataclasses.replace(get_config("glm4_9b", smoke=True),
                               dtype=dtype)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    with jax.set_mesh(mesh):
        pf, _ = japi.init_model(jcfg, jax.random.key(0))
        tree = jax.tree.map(lambda x: np.asarray(x.astype(jd)), pf)
    return jcfg, tcfg, tree


def test_params_from_jax_round_trip(mesh):
    jcfg, tcfg, tree = _setup(mesh, "bfloat16")
    p = params_from_jax(tree, tcfg, "cpu")
    assert len(p["layers"]) == tcfg.num_layers
    stack = tree["blocks"]["sub0"]
    for i, lp in enumerate(p["layers"]):
        for grp in ("attn", "mlp"):
            for name, t in lp[grp].items():
                want = np.asarray(stack[grp][name][i], np.float32)
                assert t.dtype == torch.bfloat16
                np.testing.assert_array_equal(t.float().numpy(), want)
        np.testing.assert_array_equal(
            lp["norm"]["scale"].float().numpy(),
            np.asarray(stack["norm"]["scale"][i], np.float32))
    for name in ("table", "head"):
        np.testing.assert_array_equal(
            p["embed"][name].float().numpy(),
            np.asarray(tree["embed"][name], np.float32))
    # the port's own initialiser draws the same shapes and dtypes
    own = init_model(tcfg, seed=0, device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda t: 0, own)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, p))
    assert all(a.shape == b.shape and a.dtype == b.dtype for a, b in zip(
        jax.tree.leaves(own), jax.tree.leaves(p)))
    std = own["layers"][0]["attn"]["wq"].float().std().item()
    assert abs(std - 0.88 / np.sqrt(tcfg.d_model)) < 0.02   # trunc N(0,1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serving_forward_matches_reference(mesh, dtype):
    jcfg, tcfg, tree = _setup(mesh, dtype)
    tp = params_from_jax(tree, tcfg, "cpu")
    jp = jax.tree.map(jnp.asarray, tree)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    N, bs, nb, C = 8, 8, 4, 24
    jcache = jax_init_paged_cache(jcfg, N, bs, dtype=jd)
    tcache = {k: torch.from_numpy(np.array(jcache["sub0"][k], np.float32))
              .to(torch.float32 if dtype == "float32" else torch.bfloat16)
              for k in ("k", "v")}
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, jcfg.vocab_size, 25).astype(np.int32)
    table = np.array([[1, 2, 3, 4]], np.int32)
    pcfg = ParallelConfig(remat="none")
    tol = LOGIT_TOL[dtype]

    def compare(lj, lt):
        lj = np.asarray(lj)[:, :jcfg.vocab_size]
        lt = lt.numpy()[:, :tcfg.vocab_size]
        np.testing.assert_allclose(lj, lt, atol=tol, rtol=tol)
        np.testing.assert_array_equal(lj.argmax(-1), lt.argmax(-1))

    def compare_pools():
        for k in ("k", "v"):
            np.testing.assert_allclose(
                np.asarray(jcache["sub0"][k], np.float32)[:, 1:],
                tcache[k].float().numpy()[:, 1:], atol=tol, rtol=tol)

    for start, n in ((0, 20), (20, 5)):       # two chunks of one prompt
        toks = np.zeros((1, C), np.int32)
        toks[0, :n] = prompt[start:start + n]
        b = {"tokens": toks, "q_start": np.array([start], np.int32),
             "q_lens": np.array([n], np.int32), "block_tables": table,
             "ctx_lens": np.array([start + n], np.int32)}
        with jax.set_mesh(mesh):
            lj, jcache = jtf.prefill_chunk_paged(
                jp, jcache, {k: jnp.asarray(v) for k, v in b.items()}, jcfg,
                pcfg)
        lt, tcache = ttf.prefill_chunk_paged(
            tp, tcache, {k: torch.from_numpy(v) for k, v in b.items()}, tcfg)
        compare(lj, lt)
        compare_pools()

    b = {"token": np.array([[7], [0]], np.int32),      # slot 1 idle
         "pos": np.array([25, 0], np.int32),
         "block_tables": np.concatenate([table, np.zeros_like(table)]),
         "ctx_lens": np.array([26, 0], np.int32)}
    with jax.set_mesh(mesh):
        lj, jcache = jtf.decode_step_paged(
            jp, jcache, {k: jnp.asarray(v) for k, v in b.items()}, jcfg, pcfg)
    lt, tcache = ttf.decode_step_paged(
        tp, tcache, {k: torch.from_numpy(v) for k, v in b.items()}, tcfg)
    compare(lj, lt)
    compare_pools()

"""The port's static path (``api.prefill_fn`` / ``decode_fn`` /
``init_cache`` and ``generate_static``) at smoke size on the CPU.

Against the JAX package, per dense arch: the same bf16 parameters and
prompts give the same prefill cache (within the bf16 tolerance of a whole
forward) and the same greedy tokens through prefill and four decode
steps, gemma2's 20-token prompts past its 16-token window. Inside the
port, the counterpart of ``tests/test_decode_consistency.py``: decoding
token S + 1 from a prefilled cache gives the token a fresh prefill of the
S + 1 prefix gives. The SSM and hybrid models' static path:
``test_torch_static_ssm.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ParallelConfig as JPar
from repro.config import get_config as jax_get_config
from repro.models import api as japi
from repro_torch.config import get_config
from repro_torch.models import api
from repro_torch.models.api import params_from_jax
from repro_torch.spmd import steps
import torch_cpu  # noqa: F401  (one torch thread)

DENSE = ["glm4_9b", "qwen3_32b", "starcoder2_3b", "gemma2_27b"]
# bf16 over a whole forward (see test_torch_dense_family.py)
TOL = 5e-2


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _trees(mesh, arch):
    jcfg = jax_get_config(arch, smoke=True)
    with jax.set_mesh(mesh):
        pf, _ = japi.init_model(jcfg, jax.random.key(0))
        tree = jax.tree.map(lambda x: np.asarray(x.astype(jnp.bfloat16)), pf)
    tcfg = get_config(arch, smoke=True)
    return jcfg, tcfg, tree, params_from_jax(tree, tcfg, "cpu")


@pytest.mark.parametrize("arch", DENSE)
def test_static_path_matches_reference(mesh, arch):
    jcfg, tcfg, tree, tp = _trees(mesh, arch)
    jp = jax.tree.map(jnp.asarray, tree)
    pcfg = JPar(remat="none")
    B, S, N = 2, 20, 4
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jprefill = jax.jit(lambda p, b: japi.prefill_fn(p, b, jcfg, pcfg))
    jdecode = jax.jit(lambda p, c, b: japi.decode_fn(p, c, b, jcfg, pcfg))
    with jax.set_mesh(mesh):
        jc, jtok = jprefill(jp, {"tokens": jnp.asarray(toks)})
    prefill, decode = steps.make_prefill_step(tcfg), \
        steps.make_decode_step(tcfg)
    tc, ttok = prefill(tp, {"tokens": torch.from_numpy(toks)})
    assert ttok.dtype == torch.int32 and ttok.shape == (B,)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    P = len(jc)
    for n in ("k", "v"):
        assert tc[n].shape == (tcfg.num_layers, B, S, tcfg.num_kv_heads,
                               tcfg.head_dim)
        for layer in range(tcfg.num_layers):
            want = np.asarray(jc[f"sub{layer % P}"][n][layer // P],
                              np.float32)
            np.testing.assert_allclose(tc[n][layer].float().numpy(), want,
                                       atol=TOL, rtol=TOL)
    # grow both caches to S + N and decode N steps on the same tokens
    with jax.set_mesh(mesh):
        jc = jax.tree.map(lambda x: jnp.pad(
            x, ((0, 0), (0, 0), (0, N), (0, 0), (0, 0))), jc)
    cache = api.init_cache(tcfg, B, S + N, "cpu")
    for n in ("k", "v"):
        assert cache[n].dtype == torch.bfloat16
        cache[n][:, :, :S] = tc[n]
    jt, tt = jtok, ttok
    for i in range(N):
        pos = np.full((B,), S + i, np.int32)
        with jax.set_mesh(mesh):
            jt, jc = jdecode(jp, jc, {"token": jt[:, None],
                                      "pos": jnp.asarray(pos)})
        tt, cache = decode(tp, cache, {"token": tt[:, None],
                                       "pos": torch.from_numpy(pos)})
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt),
                                      err_msg=f"step {i}")
    out = api.generate_static(tp, torch.from_numpy(toks), tcfg, N + 1)
    assert out.shape == (B, N + 1) and out.dtype == torch.int32
    np.testing.assert_array_equal(out[:, 0].numpy(), ttok.numpy())


@pytest.mark.parametrize("arch", DENSE)
def test_decode_equals_fresh_prefill(mesh, arch):
    """prefill(S) into an (S + 1)-position cache, then decode(token S),
    gives the token prefill(S + 1) gives; S = 20 puts gemma2's local layers past their window."""
    _, cfg, _, params = _trees(mesh, arch)
    B, S = 2, 20
    rng = np.random.default_rng(7)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + 1))
                            .astype(np.int32))
    _, truth = api.prefill_fn(params, {"tokens": toks}, cfg)
    # the prefill writes into a cache of S + 1 positions, the last zero
    cache, _ = api.prefill_fn(params, {"tokens": toks[:, :S]}, cfg,
                              max_len=S + 1)
    for n in ("k", "v"):
        assert cache[n].shape == (cfg.num_layers, B, S + 1,
                                  cfg.num_kv_heads, cfg.head_dim)
        assert not cache[n][:, :, S].any()
    tok, cache = api.decode_fn(params, cache, {
        "token": toks[:, S:], "pos": torch.full((B,), S, dtype=torch.int32)},
        cfg)
    assert torch.equal(tok, truth)
    # the decode step wrote token S's K/V where the fresh prefill has it
    kv1, _ = api.prefill_fn(params, {"tokens": toks}, cfg)
    for n in ("k", "v"):
        np.testing.assert_allclose(cache[n][:, :, S].float().numpy(),
                                   kv1[n][:, :, S].float().numpy(),
                                   atol=1e-2, rtol=1e-2)


def test_static_path_in_fp32(mesh):
    """With fp32 activations the port's static tokens equal the
    reference's through prefill and decode (gemma2: windows, both caps,
    post-block norms, the embedding scale)."""
    jcfg = dataclasses.replace(jax_get_config("gemma2_27b", smoke=True),
                               dtype="float32")
    tcfg = dataclasses.replace(get_config("gemma2_27b", smoke=True),
                               dtype="float32")
    with jax.set_mesh(mesh):
        pf, _ = japi.init_model(jcfg, jax.random.key(1))
    tree = jax.tree.map(np.asarray, pf)
    tp = params_from_jax(tree, tcfg, "cpu")
    toks = np.random.default_rng(4).integers(0, 256, (2, 24)).astype(
        np.int32)
    N = 6
    out = api.generate_static(tp, torch.from_numpy(toks), tcfg, N)
    pcfg = JPar(remat="none")
    jdecode = jax.jit(lambda p, c, b: japi.decode_fn(p, c, b, jcfg, pcfg))
    with jax.set_mesh(mesh):
        jp = jax.tree.map(jnp.asarray, tree)
        jc, t = japi.prefill_fn(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                                pcfg)
        jc = jax.tree.map(lambda x: jnp.pad(
            x, ((0, 0), (0, 0), (0, N), (0, 0), (0, 0))), jc)
        want = [t]
        for i in range(N - 1):
            t, jc = jdecode(jp, jc, {"token": t[:, None],
                                     "pos": jnp.full((2,), 24 + i,
                                                     jnp.int32)})
            want.append(t)
    np.testing.assert_array_equal(out.numpy(), np.stack(
        [np.asarray(w) for w in want], axis=1))

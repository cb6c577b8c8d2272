"""The static path of the SSM and hybrid models in the port
(``api.prefill_fn`` / ``decode_fn`` / ``init_cache`` and
``generate_static`` for mamba2_370m and zamba2_2p7b) at smoke size on
the CPU.

Against the JAX package (the same parameters, the port's seeded draw
in both layouts; the same 20-token prompts, which the prefill's scan
pads to three 8-row chunks), at fp32 activations as
``test_torch_ssm.py`` holds the serving forward: the prefill's cache,
each mamba layer's conv tail and final SSM state and zamba2's shared
block K/V per period, within 1e-4 (the frameworks sum in other orders),
and the greedy tokens through the prefill and four decode steps equal. Inside
the port, the counterpart of ``tests/test_decode_consistency.py``: a
decode step from a prefilled cache gives the token a fresh prefill of
the longer prompt gives. And the static tokens equal the port engine's
(SSMRunner / HybridRunner, 8-token chunks), up to a first difference at
a near-tie."""

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
from repro_torch.models import api, transformer
from repro_torch.models.api import params_from_jax
from repro_torch.serving import InferenceEngine, Request
from torch_train_cases import jax_layout
import torch_cpu  # noqa: F401  (one torch thread)

ARCHS = ["mamba2_370m", "zamba2_2p7b"]
FP32_TOL = 1e-4        # test_torch_ssm.py's fp32 tolerance
BF16_TOL = 1e-2


@pytest.fixture(scope="module")
def trees():
    """Per arch: fp32 parameters from the port's ``init_model`` in both
    layouts and both packages' fp32 configs (the reference comparison),
    and bf16 ones (the port-internal checks)."""
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out = {}
    for arch in ARCHS:
        jcfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                                   dtype="float32")
        tcfg = dataclasses.replace(get_config(arch, smoke=True),
                                   dtype="float32")
        tree = jax_layout(api.init_model(tcfg, 0, "cpu"), tcfg)
        out[arch, "float32"] = (mesh, jcfg, tcfg, tree,
                                params_from_jax(tree, tcfg, "cpu"))
        cfg = get_config(arch, smoke=True)
        out[arch, "bfloat16"] = (None, None, cfg, None,
                                 api.init_model(cfg, 0, "cpu"))
    return out


def _close(got, want, tol=FP32_TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _check_cache(tc, jc, cfg):
    """The port's layer-order cache against the reference's period-stacked
    one: mamba layer l is sub{l % P}[l // P], the shared block's period p
    is shared[p]."""
    kinds, NP = transformer.period_structure(cfg)
    P = len(kinds)
    assert tc["conv"].shape[0] == cfg.num_layers
    for layer in range(cfg.num_layers):
        conv, ssm = jc[f"sub{layer % P}"]
        _close(tc["conv"][layer], conv[layer // P])
        _close(tc["ssm"][layer], ssm[layer // P])
    if cfg.shared_attn_period:
        assert tc["k"].shape[0] == NP
        for n in ("k", "v"):
            for p in range(NP):
                _close(tc[n][p], jc["shared"][n][p])
    else:
        assert "k" not in tc


@pytest.mark.parametrize("arch", ARCHS)
def test_static_path_matches_reference(trees, arch):
    mesh, jcfg, tcfg, tree, tp = trees[arch, "float32"]
    jp = jax.tree.map(jnp.asarray, tree)
    pcfg = JPar(remat="none")
    B, S, N = 2, 20, 4
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (B, S)) \
        .astype(np.int32)
    jdecode = jax.jit(lambda p, c, b: japi.decode_fn(p, c, b, jcfg, pcfg))
    with jax.set_mesh(mesh):
        jc, jtok = japi.prefill_fn(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                                   pcfg)
    tc, ttok = api.prefill_fn(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                              max_len=S + N)
    assert ttok.dtype == torch.int32
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    assert tc["conv"].dtype == tc["ssm"].dtype == torch.float32
    _check_cache({n: t[:, :, :S] if n in ("k", "v") else t
                  for n, t in tc.items()}, jc, tcfg)
    if "k" in tc:
        assert not tc["k"][:, :, S:].any()
        with jax.set_mesh(mesh):
            jc = dict(jc, shared=jax.tree.map(lambda x: jnp.pad(
                x, ((0, 0), (0, 0), (0, N), (0, 0), (0, 0))), jc["shared"]))
    jt, tt = jtok, ttok
    for i in range(N):
        pos = np.full((B,), S + i, np.int32)
        with jax.set_mesh(mesh):
            jt, jc = jdecode(jp, jc, {"token": jt[:, None],
                                      "pos": jnp.asarray(pos)})
        tt, tc = api.decode_fn(tp, tc, {"token": tt[:, None],
                                        "pos": torch.from_numpy(pos)}, tcfg)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt),
                                      err_msg=f"step {i}")
    _check_cache({n: t[:, :, :S + N] if n in ("k", "v") else t
                  for n, t in tc.items()}, jc, tcfg)
    out = api.generate_static(tp, torch.from_numpy(toks), tcfg, N + 1)
    assert out.shape == (B, N + 1)
    np.testing.assert_array_equal(out[:, 0].numpy(), ttok.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_equals_fresh_prefill(trees, arch):
    """prefill(S) into an (S + 1)-position cache, then decode(token S),
    gives the token prefill(S + 1) gives, and the decode's new state and
    K/V rows are the fresh prefill's within the bf16 tolerance (5e-2, a
    whole forward's, as test_torch_static.py holds it)."""
    _, _, cfg, _, params = trees[arch, "bfloat16"]
    B, S = 2, 12
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32))
    full, truth = api.prefill_fn(params, {"tokens": toks}, cfg)
    cache, _ = api.prefill_fn(params, {"tokens": toks[:, :S]}, cfg,
                              max_len=S + 1)
    tok, cache = api.decode_fn(params, cache, {
        "token": toks[:, S:], "pos": torch.full((B,), S, dtype=torch.int32)},
        cfg)
    assert torch.equal(tok, truth)
    assert cache["conv"].dtype == torch.bfloat16
    assert cache["ssm"].dtype == torch.float32
    for n in ("conv", "ssm"):
        _close(cache[n], full[n].float().numpy(), 5e-2)
    if "k" in cache:
        for n in ("k", "v"):
            _close(cache[n][:, :, S], full[n][:, :, S].float().numpy(), 5e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_static_tokens_equal_engine(trees, arch):
    """Three 20-token prompts, 8 new tokens: the engine (8-token chunks,
    the smoke SSD chunk) gives generate_static's tokens, or parts from it
    at a near-tie (the static path's own logits, top-2 margin below
    1e-2)."""
    _, _, cfg, _, params = trees[arch, "bfloat16"]
    toks = np.random.default_rng(13).integers(0, cfg.vocab_size, (3, 20)) \
        .astype(np.int32)
    want = api.generate_static(params, torch.from_numpy(toks), cfg, 8)
    eng = InferenceEngine(cfg, device="cpu", params=params, max_batch=3,
                          block_size=8, max_len=48,
                          max_num_batched_tokens=3 + 8)
    reqs = [Request(t.copy(), max_new=8) for t in toks]
    outs = eng.run(reqs)
    for t, r, w in zip(toks, reqs, want.tolist()):
        ours = outs[r.rid].tolist()
        if ours == w:
            continue
        i = next(j for j, (a, b) in enumerate(zip(ours, w)) if a != b)
        prefix = torch.from_numpy(np.concatenate([t, ours[:i]])[None]
                                  .astype(np.int32))
        _, lg = transformer.prefill_logits(params, {"tokens": prefix}, cfg)
        top2 = torch.topk(lg[0, :cfg.vocab_size], 2)
        assert set(top2.indices.tolist()) == {ours[i], w[i]}
        assert float(top2.values[0] - top2.values[1]) < BF16_TOL

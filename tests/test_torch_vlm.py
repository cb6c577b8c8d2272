"""The port's M-RoPE and qwen2-vl's static path at smoke size on the CPU.

The three position planes are distinct here, as a vision frontend gives
them (an image's t / h / w grid ids, then text continuing past their
largest on all three), so a wrong section split shows: with one arange
broadcast to all planes (the JAX package's ``make_batch``) M-RoPE equals
1-D RoPE. ``rope_cos_sin`` equals the JAX package's at 1e-6; the static
prefill and decode (``api.prefill_fn`` / ``decode_fn``,
``generate_static``) give the JAX package's caches (fp32 and bf16) and
greedy tokens (fp32; in bf16 a sequence's first token equals the
reference's or parts at a top-2 margin below the bf16 tolerance, and the
streams may part after it). The serving engine refuses a vision
frontend with the reference's ValueError, and the paged chunk refuses
M-RoPE."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ParallelConfig as JPar
from repro.config import get_config as jax_get_config
from repro.models import api as japi
from repro.models.layers import rope_cos_sin as jax_rope
from repro_torch.config import get_config
from repro_torch.models import api, transformer
from repro_torch.models.api import params_from_jax
from repro_torch.models.layers import rope_cos_sin
from repro_torch.serving import InferenceEngine
import torch_cpu  # noqa: F401  (one torch thread)

ARCH = "qwen2_vl_2b"
PCFG = JPar(remat="none")


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def mrope_positions(B: int, S: int, grid=(1, 3, 4), offset=0):
    """(3, B, S) int32: a t x h x w image grid's ids at the start of each
    sequence (shifted by ``offset`` per sequence), then text positions
    continuing past the grid's largest id on all three planes."""
    t, h, w = np.meshgrid(*(np.arange(n) for n in grid), indexing="ij")
    img = np.stack([t.ravel(), h.ravel(), w.ravel()])     # (3, n_img)
    n_img = img.shape[1]
    out = np.zeros((3, B, S), np.int32)
    for b in range(B):
        start = img.max() + 1
        text = np.arange(start, start + S - n_img)
        out[:, b, :n_img] = img + b * offset
        out[:, b, n_img:] = text + b * offset
    return out


def test_rope_cos_sin_matches_reference_with_distinct_planes():
    for hd, sections, theta in ((12, (2, 2, 2), 10000.0),
                                (128, (16, 24, 24), 1000000.0)):
        pos = mrope_positions(2, 20, offset=3)
        assert not (pos[0] == pos[1]).all() and not (pos[1] == pos[2]).all()
        cj, sj = jax_rope(jnp.asarray(pos), hd, theta, sections)
        ct, st = rope_cos_sin(torch.from_numpy(pos), hd, theta, sections)
        assert ct.shape == (2, 20, hd // 2)
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-6)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-6)
        # the planes matter: 1-D rope of plane 0 differs
        c1, _ = rope_cos_sin(torch.from_numpy(pos[0]), hd, theta)
        assert not torch.allclose(c1, ct)
    with pytest.raises(ValueError, match="sections"):
        rope_cos_sin(torch.zeros((3, 1, 4), dtype=torch.int32), 12, 1e4,
                     (2, 2, 3))


def _run_both(mesh, dtype):
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True),
                               dtype=dtype)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    with jax.set_mesh(mesh):
        pf, _ = japi.init_model(jcfg, jax.random.key(0))
        tree = jax.tree.map(lambda x: np.asarray(x.astype(jdt)), pf)
    params = params_from_jax(tree, tcfg, "cpu")
    B, S, N = 2, 20, 5
    toks = np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (B, S)).astype(np.int32)
    pos = mrope_positions(B, S, offset=2)
    with jax.set_mesh(mesh):
        jp = jax.tree.map(jnp.asarray, tree)
        jc, jt = japi.prefill_fn(jp, {"tokens": jnp.asarray(toks),
                                      "positions": jnp.asarray(pos)},
                                 jcfg, PCFG)
        kv0 = jc
        jc = jax.tree.map(lambda x: jnp.pad(
            x, ((0, 0), (0, 0), (0, N), (0, 0), (0, 0))), jc)
        want = [np.asarray(jt)]
        for i in range(N - 1):
            jt, jc = japi.decode_fn(jp, jc, {"token": jt[:, None],
                                             "pos": jnp.full((B,), S + i,
                                                             jnp.int32)},
                                    jcfg, PCFG)
            want.append(np.asarray(jt))
    cache, _ = api.prefill_fn(params, {"tokens": torch.from_numpy(toks),
                                       "positions": torch.from_numpy(pos)},
                              tcfg)
    out = api.generate_static(params, torch.from_numpy(toks), tcfg, N,
                              positions=torch.from_numpy(pos))
    _, logits = transformer.prefill_logits(
        params, {"tokens": torch.from_numpy(toks),
                 "positions": torch.from_numpy(pos)}, tcfg)
    return (tcfg, kv0, cache, np.stack(want, 1), out.numpy(),
            logits[:, :tcfg.vocab_size].numpy())


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 5e-2)])
def test_static_path_matches_reference(mesh, dtype, tol):
    tcfg, kv0, cache, want, got, logits = _run_both(mesh, dtype)
    for n in ("k", "v"):
        ref = np.asarray(kv0["sub0"][n], np.float32)
        np.testing.assert_allclose(cache[n].float().numpy(), ref, rtol=0,
                                   atol=tol * np.abs(ref).max())
    if dtype == "float32":
        np.testing.assert_array_equal(got, want)
        return
    for b in range(len(got)):
        if got[b, 0] != want[b, 0]:
            top2 = np.argsort(-logits[b])[:2]
            assert set(top2.tolist()) == {got[b, 0], want[b, 0]}
            assert logits[b, top2[0]] - logits[b, top2[1]] < 1e-2


def test_engine_refuses_vision_and_chunk_refuses_mrope():
    cfg = get_config(ARCH, smoke=True)
    with pytest.raises(ValueError, match="frontend"):
        InferenceEngine(cfg, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    one = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="M-RoPE"):
        transformer.prefill_chunk_paged(
            {}, {}, {"tokens": toks, "q_start": 0 * one, "q_lens": 4 * one,
                     "block_tables": one[None], "ctx_lens": 4 * one}, cfg)

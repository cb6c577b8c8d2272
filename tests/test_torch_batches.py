"""Batches and the streaming plain attention in the port, against the JAX
package at smoke size on the CPU.

* ``api.make_batch`` (and ``data.pipeline.synthetic_batch``) gives the
  JAX package's batch byte for byte for all ten archs, at train, prefill
  and decode shapes: tokens and labels, whisper's bf16 frames, qwen2_vl's
  (3, B, S) positions.
* ``spmd.steps._split_microbatches`` splits as the JAX package's does:
  positions on their dim 1, every other entry on dim 0.
* ``block_causal_attention`` and ``chunked_attention``, the plain path
  beyond ``DENSE_ATTN_MAX_KV`` keys, against the JAX package's: fp32
  within 1e-5, bf16 within 1e-2 (the port's ladder); and
  ``ops.flash_attention`` on the CPU at ``DENSE_ATTN_MAX_KV + 1`` keys
  runs them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import ALL_ARCHS
from repro.config import ShapeConfig as JShape
from repro.config import get_config as jax_get_config
from repro.models import api as japi
from repro.models import attention as jatt
from repro.spmd import steps as jsteps
from repro_torch.config import ShapeConfig, get_config
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.kernels import ops
from repro_torch.models import api
from repro_torch.models import attention as tatt
from repro_torch.spmd import steps as tsteps
import torch_cpu  # noqa: F401  (one torch thread)


def _bytes(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return "bfloat16", tuple(x.shape), x.view(torch.int16).numpy() \
                .tobytes()
        return str(x.numpy().dtype), tuple(x.shape), x.numpy().tobytes()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return "bfloat16", a.shape, a.view(np.uint16).tobytes()
    return str(a.dtype), a.shape, a.tobytes()


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_make_batch_byte_equal_to_jax(arch):
    jcfg, tcfg = jax_get_config(arch, smoke=True), get_config(arch,
                                                             smoke=True)
    for kind, seed in (("train", 0), ("prefill", 3), ("decode", 5)):
        want = japi.make_batch(jcfg, JShape("s", 16, 4, kind), seed)
        got = api.make_batch(tcfg, ShapeConfig("s", 16, 4, kind), seed,
                             "cpu")
        assert list(got) == list(want)
        assert {k: (str(d).replace("torch.", ""), s) for k, (s, d) in
                api.batch_shapes(tcfg, ShapeConfig("s", 16, 4, kind))
                .items()} == {k: (jnp.dtype(d).name, s) for k, (s, d) in
                              japi.batch_shapes(jcfg, JShape("s", 16, 4,
                                                             kind)).items()}
        for k in want:
            assert _bytes(got[k]) == _bytes(want[k]), (kind, k)
    same = synthetic_batch(tcfg, ShapeConfig("s", 16, 4, "train"), 0, "cpu")
    assert all(torch.equal(same[k], v) for k, v in api.make_batch(
        tcfg, ShapeConfig("s", 16, 4, "train"), 0, "cpu").items())
    if tcfg.frontend == "vision":
        assert same["positions"].shape == (3, 4, 16)


def test_split_microbatches_matches_jax():
    """positions (3, B, S) split on dim 1, tokens, labels and frames on
    dim 0: microbatch i of each entry equals the JAX package's."""
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 99, (6, 5)).astype(np.int32),
             "labels": rng.integers(0, 99, (6, 5)).astype(np.int32),
             "positions": rng.integers(0, 99, (3, 6, 5)).astype(np.int32),
             "frames": rng.normal(0, 1, (6, 7, 4)).astype(np.float32)}
    want = jsteps._split_microbatches(
        {k: jnp.asarray(v) for k, v in batch.items()}, 3)
    got = tsteps._split_microbatches(
        {k: torch.from_numpy(v) for k, v in batch.items()}, 3)
    assert len(got) == 3
    for i, mb in enumerate(got):
        assert mb["positions"].shape == (3, 2, 5)
        for k, v in mb.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(want[k][i]))
    with pytest.raises(ValueError, match="positions"):
        tsteps._split_microbatches({"positions": torch.zeros((3, 5, 2))}, 2)


CASES = [  # (Sq, Skv, H, K, causal, window, cap, q_offset, chunk_kv)
    (40, 40, 4, 2, True, 12, 20.0, 0, 16),
    (8, 40, 4, 1, True, None, None, 32, 16),
    (24, 40, 2, 2, False, None, 30.0, 0, 16),
]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_streaming_attention_matches_jax(case, dtype):
    Sq, Skv, H, K, causal, window, cap, q_offset, chunk = case
    rng = np.random.default_rng(sum(case[:4]))
    q, k, v = (rng.normal(0, 1, s).astype(np.float32) for s in
               ((2, Sq, H, 16), (2, Skv, K, 16), (2, Skv, K, 16)))
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jq, jk, jv = (jnp.asarray(a, jd) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(td) for a in (q, k, v))
    tol = 1e-5 if dtype == "float32" else 1e-2
    kw = dict(window=window, cap=cap, scale=0.3, chunk_kv=chunk)
    pairs = [(tatt.chunked_attention(tq, tk, tv, causal=causal,
                                     q_offset=q_offset, **kw),
              jatt.chunked_attention(jq, jk, jv, causal=causal,
                                     q_offset=q_offset, **kw))]
    if causal and Sq == Skv and q_offset == 0:
        pairs.append((tatt.block_causal_attention(tq, tk, tv, block_q=16,
                                                  **kw),
                      jatt.block_causal_attention(jq, jk, jv, block_q=16,
                                                  **kw)))
    for got, want in pairs:
        assert got.dtype == td
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=tol,
                                   rtol=tol)


def test_flash_attention_streams_beyond_the_dense_limit():
    """Causal self attention over DENSE_ATTN_MAX_KV + 1 keys on the CPU
    (the block-causal path) gives the rectangular chunked scan's values,
    with and without a window."""
    n = ops.DENSE_ATTN_MAX_KV + 1
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (1, n, 1, 4)).astype(np.float32))
    for window in (None, 700):
        got = ops.flash_attention(x, x, x, window=window)
        want = tatt.chunked_attention(x, x, x, window=window)
        assert got.shape == x.shape
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)

"""int8 / fp8 KV pools in the port against the JAX package.

The quantizer gives the JAX package's bits; the pools and their byte
accounting have the JAX package's shapes and sizes; the plain decode,
chunk and packed paths over quantized pools (dequantized after the gather)
match the JAX package's XLA paths given the same pools; and the engine
serves int8 and fp8 pools with the JAX engine's greedy tokens (near-tie
rule as in ``test_torch_engine.py``). The CUDA kernels' fused dequant is
held against the plain versions on the card (the CUDA-only test at the
end, and ``chip_smoke.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jax_get_config
from repro.kernels import ops as jops
from repro.models import quant as jq
from repro.serving import InferenceEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving.kv_cache import block_bytes as jax_block_bytes
from repro.serving.kv_cache import init_paged_cache as jax_init_paged_cache
from repro_torch.config import get_config
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tatt
from repro_torch.models import quant as tq
from repro_torch.serving.kv_cache import block_bytes, init_paged_cache
from test_torch_ragged_prefill import (assert_rows_close,
                                       assert_same_or_near_tie, both,
                                       ragged_case, run_port, to_torch)
from test_torch_ragged_prefill import setup  # noqa: F401 (module fixture)
import torch_cpu  # noqa: F401  (one torch thread)

BF16_TOL = 1e-2
# max_batch 2, 16-token blocks, 12-token chunks, 7 allocatable blocks:
# prefix hits with a boundary COW, preemption and chunked prefill
TIGHT = dict(max_batch=2, block_size=16, max_len=96, num_blocks=8,
             max_num_batched_tokens=2 + 12)


def quant_rows(kv):
    """Rows that reach every corner of the quantizer: random ones, an
    all-zero row, rows whose absmax code is exactly +-qmax, halfway values
    (round half to even for int8) and tiny values below one code."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 2, (40, 2, 16)).astype(np.float32)
    x[0] = 0.0
    x[1, 0] = np.linspace(-1.0, 1.0, 16)           # +-qmax at both ends
    x[1, 1] = -x[1, 0]
    # a scale of exactly 0.25 makes the codes 4x: halfway between two
    # codes (round half to even) for int8, and between two fp8 values
    qmax = tq.QMAX[kv]
    x[2, 0, 0] = qmax * 0.25
    x[2, 0, 1:] = 0.25 * ((np.arange(15) + 0.5) if kv == "int8"
                          else 17 + 2 * np.arange(15))
    x[2, 1] = -x[2, 0]
    x[3] = rng.normal(0, 1e-7, (2, 16))            # below the eps floor
    x[4, :, 0] = 1e4                               # one huge value per row
    return x


@pytest.mark.parametrize("kv", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_dequantize_bit_equal(kv, dtype):
    xj, xt = both(quant_rows(kv), dtype)
    qj, sj = jq.quantize_kv(xj, kv)
    qt, st = tq.quantize_kv(xt, kv)
    assert qt.dtype == tq.KV_DTYPES[kv] and st.dtype == torch.float32
    assert qt.shape == xt.shape and st.shape == xt.shape[:-1] + (1,)
    np.testing.assert_array_equal(np.asarray(qj).view(np.uint8),
                                  qt.view(torch.uint8).numpy())
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())
    assert qt[1].float().abs().amax() == tq.QMAX[kv]   # the extremes hit
    assert (qt[0].float() == 0).all() and (st[0] > 0).all()
    dj = jq.dequantize_kv(qj, sj)
    dt = tq.dequantize_kv(qt, st)
    assert dt.dtype == torch.bfloat16
    np.testing.assert_array_equal(np.asarray(dj).view(np.uint16),
                                  dt.view(torch.uint16).numpy())
    # the port's dequant of JAX-made codes gives the same bits too
    assert torch.equal(tq.dequantize_kv(to_torch(qj), to_torch(sj)), dt)


@pytest.mark.parametrize("kv", ["bf16", "int8", "fp8"])
def test_cache_layout_and_bytes_match_reference(kv):
    for smoke in (True, False):
        cfg = get_config("glm4_9b", smoke)
        jcfg = jax_get_config("glm4_9b", smoke)
        assert block_bytes(cfg, 16, kv_dtype=kv) == \
            jax_block_bytes(jcfg, 16, kv_dtype=kv)
    cfg, jcfg = get_config("glm4_9b", True), jax_get_config("glm4_9b", True)
    ours = init_paged_cache(cfg, 5, 8, "cpu", kv)
    ref = jax_init_paged_cache(jcfg, 5, 8, kv_dtype=kv)["sub0"]
    assert sorted(ours) == sorted(ref)
    for name, t in ours.items():
        r = np.asarray(ref[name])
        assert tuple(t.shape) == r.shape, name
        assert to_torch(r).dtype == t.dtype, name
        assert not t.view(torch.uint8).any(), name
    assert tq.kv_dtype_bytes(kv) == jq.kv_dtype_bytes(kv)
    assert tq.kv_dtype_name(ours["k"].dtype) == kv
    assert tq.is_quantized(kv) == jq.is_quantized(kv)


def _quant_pools(rng, shape, kv):
    """Random K/V pools quantized by the JAX package, as (jax, torch)
    pairs: (k, v, k_scale, v_scale)."""
    out = []
    for _ in range(2):
        q, s = jq.quantize_kv(jnp.asarray(rng.normal(0, 1, shape),
                                          jnp.bfloat16), kv)
        out.append(((q, to_torch(q)), (s, to_torch(s))))
    (k, ks), (v, vs) = out
    return k, v, ks, vs


@pytest.mark.parametrize("kv", ["int8", "fp8"])
@pytest.mark.parametrize("path", ["decode", "chunk", "ragged"])
def test_plain_paths_with_scales_vs_reference(kv, path):
    """The port's plain paths over quantized pools against the JAX
    package's XLA paths given the same pools (bf16 tolerance)."""
    rng = np.random.default_rng(["decode", "chunk", "ragged"].index(path))
    H, K, hd, bs, nblk = 8, 2, 32, 8, 4
    kw = dict(window=20, cap=30.0)
    if path == "ragged":
        q, kp, _, bt, ctx, st, en, seq = ragged_case(
            rng, H, K, hd, bs, nblk, 24, [7, 0, 9, 8], [16, 0, 9, 32])
        meta = [both(a) for a in (bt, ctx, st, en, seq)]
        fj, ft = jops.ragged_paged_prefill_attention, \
            ops.ragged_paged_prefill_attention
    else:
        B = 3
        q = rng.normal(0, 1, (B, H, hd) if path == "decode"
                       else (B, 12, H, hd))
        bt = rng.permutation(np.arange(1, 1 + B * nblk)).reshape(B, nblk) \
            .astype(np.int32)
        ctx = np.array([30, 0, 13], np.int32)
        meta = [both(bt), both(ctx)]
        fj, ft = jops.paged_attention, ops.paged_attention
        if path == "chunk":
            meta.append(both(np.array([12, 0, 5], np.int32)))
            fj, ft = jops.paged_prefill_attention, ops.paged_prefill_attention
        kp = np.zeros((1 + B * nblk, bs, K, hd))
    k, v, ks, vs = _quant_pools(rng, kp.shape, kv)
    qj, qt = both(q, "bfloat16")
    o_j = fj(qj, k[0], v[0], *(m[0] for m in meta), k_scale=ks[0],
             v_scale=vs[0], **kw)
    o_t = ft(qt, k[1], v[1], *(m[1] for m in meta), k_scale=ks[1],
             v_scale=vs[1], **kw)
    assert o_t.dtype == torch.bfloat16 and o_t.shape == qt.shape
    np.testing.assert_allclose(np.asarray(o_j, np.float32),
                               o_t.float().numpy(), atol=BF16_TOL)
    # the dequantized pool is what the plain path attends: the same
    # output as a bf16 pool holding the dequantized values
    deq = [tq.dequantize_kv(p, s) for p, s in ((k[1], ks[1]), (v[1], vs[1]))]
    assert torch.equal(o_t, ft(qt, *deq, *(m[1] for m in meta), **kw))


def test_narrow_pool_refuses_float_rows():
    """Into an int8 or fp8 pool only rows of its own dtype go: a float row
    would be truncated, so each update function raises."""
    bt = torch.tensor([[1, 2]], dtype=torch.int32)
    zero, one = torch.zeros(1, dtype=torch.int32), \
        torch.ones(1, dtype=torch.int32)
    for kv in ("int8", "fp8"):
        pool = init_paged_cache(get_config("glm4_9b", True), 3, 4, "cpu",
                                kv)["k"][0]
        rows = torch.randn(1, 1, 2, 16, dtype=torch.bfloat16)
        calls = [
            lambda r: tatt.update_paged_cache(pool, r, bt, one),
            lambda r: tatt.update_paged_cache_chunk(pool, r, bt, zero, one),
            lambda r: tatt.update_paged_cache_ragged(
                pool, r, bt, one, zero, one, zero),
        ]
        for call in calls:
            with pytest.raises(TypeError, match="quantize"):
                call(rows)
            with pytest.raises(TypeError, match="quantize"):
                call(rows.float())
        q, _ = tq.quantize_kv(rows, kv)
        for call in calls:
            assert call(q) is pool
        assert torch.equal(pool[1, 1].view(torch.uint8),
                           q[0, 0].view(torch.uint8))


def test_cow_copy_moves_scale_rows(setup):
    """The engine's copy-on-write copies a block's rows in every pool of a
    quantized cache: values and scales."""
    eng, _, _ = run_port(setup, [], kv_dtype="int8", **TIGHT)
    assert sorted(eng.cache) == ["k", "k_scale", "v", "v_scale"]
    for pool in eng.cache.values():
        raw = pool.view(torch.uint8)
        raw.copy_(torch.randint(0, 100, raw.shape, dtype=torch.uint8))
    eng._copy_block(2, 5)
    for name, pool in eng.cache.items():
        assert torch.equal(pool[:, 5].view(torch.uint8),
                           pool[:, 2].view(torch.uint8)), name


@pytest.mark.parametrize("kv,pack", [("int8", 1), ("fp8", 1), ("int8", 4),
                                     ("fp8", 4)])
def test_engine_quantized_greedy_matches_reference(setup, kv, pack):
    """Prefix hits with a boundary COW, preemption and chunked or packed
    prefill over int8 / fp8 pools, in one run of each package."""
    cfg, mesh, tree, _, _ = setup
    # test_torch_engine.py's prompts: a shared 32-token prefix, the prefix
    # alone (a two-block full hit: a boundary COW) and an unrelated one
    rng = np.random.default_rng(11)
    prefix = rng.integers(0, cfg.vocab_size, 32).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 8)
                               .astype(np.int32)]), prefix.copy(),
               np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 13)
                               .astype(np.int32)]),
               rng.integers(0, cfg.vocab_size, 20).astype(np.int32)]
    arrivals = [0, 5, 9, 9]
    jeng = JaxEngine(cfg, mesh, params=jax.tree.map(jnp.asarray, tree),
                     debug_invariants=True, kv_dtype=kv, prefill_pack=pack,
                     **TIGHT)
    jreqs = [JaxRequest(p.copy(), max_new=20) for p in prompts]
    jouts = jeng.run(jreqs, arrival_steps=arrivals)
    eng, outs, _ = run_port(setup, prompts, arrivals, max_new=20,
                            kv_dtype=kv, prefill_pack=pack, **TIGHT)
    assert eng.stats["kv_dtype"] == kv and eng.cache["k"].dtype == \
        tq.KV_DTYPES[kv]
    assert eng.stats["kv_cache_mib"] == jeng.stats["kv_cache_mib"]
    assert eng.stats["preemptions"] >= 1 and eng.stats["cow_copies"] >= 1
    for p, ours, jr in zip(prompts, outs, jreqs):
        assert len(ours) == 20 and all(0 <= t < cfg.vocab_size for t in ours)
        assert_same_or_near_tie(eng, p, ours, jouts[jr.rid].tolist())


@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_cuda_fused_dequant_vs_plain(kv):
    """The three paged kernels over quantized pools vs their plain
    versions on the card (1e-2 per row); the packed kernel's fused write
    stores the quantized codes byte for byte."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    rng = np.random.default_rng(40)
    H, K, hd, bs, nblk, T = 32, 2, 128, 16, 8, 48
    q, kp, _, bt, ctx, st, en, seq = (
        torch.from_numpy(a).cuda() for a in
        ragged_case(rng, H, K, hd, bs, nblk, T, [20, 0, 28], [100, 0, 28]))
    q = q.bfloat16()
    k, ks = tq.quantize_kv(kp.bfloat16(), kv)
    v, vs = tq.quantize_kv(torch.randn_like(kp).bfloat16(), kv)
    sc = dict(k_scale=ks, v_scale=vs)

    assert_rows_close(
        tpa.ragged_paged_prefill_attention(q, k, v, bt, ctx, st, en, **sc),
        tatt.ragged_chunk_attention_xla(q, k, v, bt, ctx, st, en, seq, **sc))
    qd = q[:3].contiguous()
    assert_rows_close(tpa.paged_attention(qd, k, v, bt, ctx, **sc),
                      tref.paged_attention_ref(qd, k, v, bt, ctx, **sc))
    qc = q[:24].reshape(3, 8, H, hd).contiguous()
    ql = torch.tensor([8, 0, 5], dtype=torch.int32, device="cuda")
    assert_rows_close(
        tpa.paged_prefill_attention(qc, k, v, bt, ctx, ql, **sc)[0],
        tatt.paged_chunk_attention_xla(qc, k, v, bt, ctx, ql, **sc)[0])
    kn, _ = tq.quantize_kv(torch.randn((T, K, hd), device="cuda"), kv)
    vn, _ = tq.quantize_kv(torch.randn((T, K, hd), device="cuda"), kv)
    k1, v1 = k.clone(), v.clone()
    tpa.ragged_paged_prefill_attention(q, k1, v1, bt, ctx, st, en,
                                       k_new=kn, v_new=vn, **sc)
    k2 = tatt.update_paged_cache_ragged(k.clone(), kn[None], bt, ctx, st,
                                        en, seq)
    assert torch.equal(k1[1:].view(torch.uint8), k2[1:].view(torch.uint8))
    assert not torch.equal(k1.view(torch.uint8), k.view(torch.uint8))
    assert v1.view(torch.uint8)[1:].equal(tatt.update_paged_cache_ragged(
        v.clone(), vn[None], bt, ctx, st, en, seq).view(torch.uint8)[1:])

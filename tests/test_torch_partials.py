"""The partial-softmax paths of pool-sharded serving and the sharding
rules, held against the JAX package on the CPU.

``kernels.ref.paged_attention_partial_ref`` / ``paged_shard_attention_ref``
and ``models.attention.stitch_paged_partials`` / ``paged_shard_attention``
against their ``repro`` counterparts (plain jnp, which run here) over GQA,
MHA and MQA heads, bf16/int8/fp8 pools, window and softcap, 1-4 shards,
at the fp32 ladder (1e-5); a full mask gives ``paged_attention_ref``'s
output bit for bit; the partials stay fp32 over bf16 pools; a random
partition of the table stitches to the unsharded result; n_shards < 1
raises. The chunk kernel's plain partial
(``ref.paged_prefill_attention_partial_ref``) has no runnable JAX
counterpart here (the Pallas kernels 1-3 fail under interpret on this
jax), so it is held against the decode partial at C = 1 and against the
full-mask chunk paths. ``spmd.sharding`` against ``repro.spmd.sharding``.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.config import ParallelConfig as JaxParallelConfig
from repro.config import get_config as jax_get_config
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.serving.kv_cache import block_bytes as jax_block_bytes
from repro.spmd import sharding as jshd
from repro_torch.config import ParallelConfig, get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as tattn
from repro_torch.models.quant import quantize_kv
from repro_torch.serving.kv_cache import block_bytes
from repro_torch.spmd import sharding as shd
import torch_cpu  # noqa: F401  (one torch thread)

FP32_TOL = 1e-5
BF16_TOL = 1e-2
# (H, K): GQA, MHA, MQA at hd 16, 8-token pages
HEADS = {"gqa": (8, 2), "mha": (4, 4), "mqa": (4, 1)}
OPTS = {"plain": {}, "window_cap": dict(window=20, cap=30.0)}


def _case(rng, H, K, kv="bf16", B=4, nb=6, bs=8, hd=16, C=None):
    """bf16 queries, pools in ``kv`` with their scale keywords, disjoint
    tables and contexts (one slot inactive, one of a single key)."""
    N = 1 + B * nb
    qshape = (B, H, hd) if C is None else (B, C, H, hd)
    q = rng.normal(size=qshape).astype(np.float32)
    kp = rng.normal(size=(N, bs, K, hd)).astype(np.float32)
    vp = rng.normal(size=(N, bs, K, hd)).astype(np.float32)
    bt = (rng.permutation(N - 1)[:B * nb] + 1).reshape(B, nb).astype(np.int32)
    ctx = np.array([nb * bs, 29, 0, 1][:B], np.int32)
    tq = torch.from_numpy(q).bfloat16()
    tk, tv = torch.from_numpy(kp).bfloat16(), torch.from_numpy(vp).bfloat16()
    sc = {}
    if kv != "bf16":
        tk, ks = quantize_kv(tk, kv)
        tv, vs = quantize_kv(tv, kv)
        sc = {"k_scale": ks, "v_scale": vs}
    return tq, tk, tv, torch.from_numpy(bt), torch.from_numpy(ctx), sc


def _jax(t):
    """A port tensor as the JAX array of the same bits (narrow pools by
    their bytes)."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)
    if t.dtype == torch.int8:
        return jnp.asarray(t.numpy())
    if t.dtype == torch.float8_e4m3fn:
        return jnp.asarray(t.view(torch.uint8).numpy()).view(
            jnp.float8_e4m3fn)
    return jnp.asarray(t.numpy())


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(ours, theirs, tol=FP32_TOL):
    np.testing.assert_allclose(ours.float().numpy(), _np(theirs), rtol=tol,
                               atol=tol)


def _mask(rng, B, nb):
    m = (rng.random((B, nb)) < 0.5).astype(np.int32)
    m[1] = 0                               # a slot this shard holds nothing of
    return torch.from_numpy(m)


@pytest.mark.parametrize("kv", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("opts", list(OPTS), ids=list(OPTS))
@pytest.mark.parametrize("heads", list(HEADS), ids=list(HEADS))
def test_partial_ref_matches_reference(heads, opts, kv):
    """The decode partial (and the CPU op) against the JAX oracle: o and
    lse within 1e-5, fp32, with the same empty rows."""
    rng = np.random.default_rng(1)
    q, kp, vp, bt, ctx, sc = _case(rng, *HEADS[heads], kv)
    mask = _mask(rng, *bt.shape)
    kw = dict(scale=None, **OPTS[opts])
    o, lse = ref.paged_attention_partial_ref(q, kp, vp, bt, ctx, mask, **kw,
                                             **sc)
    jo, jl = jref.paged_attention_partial_ref(
        _jax(q), _jax(kp), _jax(vp), _jax(bt), _jax(ctx), _jax(mask), **kw,
        **{k: _jax(v) for k, v in sc.items()})
    assert o.dtype == lse.dtype == torch.float32
    assert o.shape == q.shape and lse.shape == q.shape[:2]
    _close(o, jo)
    empty = lse <= -1e30
    assert (empty.numpy() == (_np(jl) <= -1e30)).all()
    assert bool(empty[1].all()) and bool((o[1] == 0).all())
    np.testing.assert_allclose(lse[~empty].numpy(), _np(jl)[~empty.numpy()],
                               rtol=FP32_TOL, atol=FP32_TOL)
    o2, l2 = ops.paged_attention_partial(q, kp, vp, bt, ctx, mask, **kw, **sc)
    assert torch.equal(o2, o) and torch.equal(l2, lse)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("heads", list(HEADS), ids=list(HEADS))
def test_full_mask_is_paged_attention_ref_bit_for_bit(heads, kv):
    """With every entry selected the partial's o, cast to q's dtype, is
    ``paged_attention_ref``'s output byte for byte; the partials are fp32
    although the pools are bf16 (or narrower)."""
    rng = np.random.default_rng(2)
    q, kp, vp, bt, ctx, sc = _case(rng, *HEADS[heads], kv)
    o, lse = ref.paged_attention_partial_ref(
        q, kp, vp, bt, ctx, torch.ones(bt.shape, dtype=torch.int32), **sc)
    assert o.dtype == torch.float32 and lse.dtype == torch.float32
    want = ref.paged_attention_ref(q, kp, vp, bt, ctx, **sc)
    assert torch.equal(o.to(q.dtype).view(torch.int16),
                       want.view(torch.int16))


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
@pytest.mark.parametrize("heads", list(HEADS), ids=list(HEADS))
def test_shard_attention_matches_reference(heads, n_shards):
    """``paged_shard_attention_ref`` and the model op over n shards
    against the JAX package's at 1e-5, and within the bf16 tolerance of
    the unsharded decode (each shard rounds its own normalized p)."""
    rng = np.random.default_rng(3)
    q, kp, vp, bt, ctx, _ = _case(rng, *HEADS[heads])
    kw = dict(window=20, cap=30.0)
    o = ref.paged_shard_attention_ref(q, kp, vp, bt, ctx, n_shards, **kw)
    jargs = (_jax(q), _jax(kp), _jax(vp), _jax(bt), _jax(ctx), n_shards)
    jo = jref.paged_shard_attention_ref(*jargs, **kw)
    _close(o, jo)
    om = tattn.paged_shard_attention(q, kp, vp, bt, ctx, n_shards, **kw)
    _close(om, jattn.paged_shard_attention(*jargs, **kw))
    assert torch.equal(om, o)
    full = ref.paged_attention_ref(q, kp, vp, bt, ctx, **kw)
    np.testing.assert_allclose(o.float().numpy(), full.float().numpy(),
                               rtol=BF16_TOL, atol=BF16_TOL)


def test_random_partition_stitches_to_unsharded():
    """Entries dealt to 3 shards at random (not round robin): the stitched
    partials equal the unsharded decode within the bf16 tolerance, and
    the port's stitch equals the JAX package's at 1e-5 on the same
    partials, an unattended row (every lse <= -1e30) coming out zero."""
    rng = np.random.default_rng(4)
    q, kp, vp, bt, ctx, _ = _case(rng, 8, 2, nb=10)
    owner = rng.integers(0, 3, bt.shape)
    parts = [ref.paged_attention_partial_ref(
        q, kp, vp, bt, ctx, torch.from_numpy((owner == s).astype(np.int32)))
        for s in range(3)]
    os = torch.stack([p[0] for p in parts])
    lses = torch.stack([p[1] for p in parts])
    o = tattn.stitch_paged_partials(os, lses)
    _close(o, jattn.stitch_paged_partials(_jax(os), _jax(lses)))
    assert bool((o[2] == 0).all())            # ctx 0: no shard attended
    full = ref.paged_attention_ref(q, kp, vp, bt, ctx)
    np.testing.assert_allclose(o.numpy(), full.float().numpy(),
                               rtol=BF16_TOL, atol=BF16_TOL)


def test_n_shards_below_one_raises():
    rng = np.random.default_rng(5)
    q, kp, vp, bt, ctx, _ = _case(rng, 4, 2)
    for fn in (ref.paged_shard_attention_ref, tattn.paged_shard_attention):
        with pytest.raises(ValueError, match="n_shards=0 must be >= 1"):
            fn(q, kp, vp, bt, ctx, 0)


@pytest.mark.parametrize("opts", list(OPTS), ids=list(OPTS))
@pytest.mark.parametrize("heads", list(HEADS), ids=list(HEADS))
def test_chunk_partial_matches_decode_partial_and_chunk_paths(heads, opts):
    """The chunk kernel's plain partial: at C = 1 (q_lens 1) it is the
    decode partial; with a full mask its o cast to bf16 is
    ``paged_prefill_attention_ref``'s bit for bit and within the bf16
    tolerance of ``paged_chunk_attention_xla`` on the valid rows, whose
    lse is the plain logsumexp; padding rows are zero with lse <= -1e30;
    the CPU op is the plain partial."""
    H, K = HEADS[heads]
    rng = np.random.default_rng(6)
    q, kp, vp, bt, ctx, _ = _case(rng, H, K)
    mask = _mask(rng, *bt.shape)
    kw = OPTS[opts]
    ones = torch.tensor([1, 1, 0, 1], dtype=torch.int32)
    oc, lc = ref.paged_prefill_attention_partial_ref(
        q[:, None], kp, vp, bt, ctx, ones, mask, **kw)
    od, ld = ref.paged_attention_partial_ref(q, kp, vp, bt, ctx, mask, **kw)
    torch.testing.assert_close(oc[:, 0], od, rtol=FP32_TOL, atol=FP32_TOL)
    torch.testing.assert_close(lc[:, 0], ld, rtol=FP32_TOL, atol=FP32_TOL)

    C = 12
    q, kp, vp, bt, ctx, _ = _case(rng, H, K, C=C)
    ql = torch.tensor([C, 7, 0, 1], dtype=torch.int32)
    full = torch.ones(bt.shape, dtype=torch.int32)
    o, lse = ref.paged_prefill_attention_partial_ref(q, kp, vp, bt, ctx, ql,
                                                     full, **kw)
    assert o.dtype == lse.dtype == torch.float32
    want = ref.paged_prefill_attention_ref(q, kp, vp, bt, ctx, ql, **kw)
    assert torch.equal(o.to(q.dtype).view(torch.int16),
                       want.view(torch.int16))
    xla = tattn.paged_chunk_attention_xla(q, kp, vp, bt, ctx, ql, **kw)
    for b, n in enumerate(ql.tolist()):
        np.testing.assert_allclose(o[b, :n].numpy(), xla[b, :n].float()
                                   .numpy(), rtol=BF16_TOL, atol=BF16_TOL)
        assert bool((o[b, n:] == 0).all()) and bool((lse[b, n:] <= -1e30)
                                                    .all())
    # the lse of a valid row: the logsumexp of its visible scaled logits
    hd = q.shape[-1]
    k = kp[bt[0].long()].reshape(-1, K, hd).float()
    logits = torch.einsum("cgkh,skh->cgks", q[0].reshape(C, H // K, K, hd)
                          .float(), k) * hd ** -0.5
    logits = logits if kw.get("cap") is None else \
        kw["cap"] * torch.tanh(logits / kw["cap"])
    pos = ctx[0] - C + torch.arange(C)
    d = pos[:, None] - torch.arange(k.shape[0])[None]
    ok = (d >= 0) & (d < kw.get("window", 10 ** 9))
    logits = torch.where(ok[:, None, None], logits, -torch.inf)
    torch.testing.assert_close(lse[0], torch.logsumexp(logits, -1)
                               .reshape(C, H), rtol=FP32_TOL, atol=FP32_TOL)
    o2, l2 = ops.paged_prefill_attention_partial(q, kp, vp, bt, ctx, ql, full,
                                                 **kw)
    assert torch.equal(o2, o) and torch.equal(l2, lse)


@pytest.mark.parametrize("K", [1, 2, 3, 4, 8, 32])
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_serving_rules_match_reference(K, tp):
    """``paged_pool_pspec`` (the spec, or the ValueError and its text),
    ``serving_cache_pspec`` by leaf and ``block_bytes(tp=)`` against the
    JAX package's."""
    try:
        want = tuple(jshd.paged_pool_pspec(K, tp))
    except ValueError as e:
        with pytest.raises(ValueError) as ours:
            shd.paged_pool_pspec(K, tp)
        assert str(ours.value) == str(e)
    else:
        assert shd.paged_pool_pspec(K, tp) == want
    for name in ("k", "v", "xk", "xv", "k_scale", "v_scale", "conv", "ssm"):
        for shape in ((2, 5, 16, K, 8), (2, 5, 16, K)):
            path = (jax.tree_util.DictKey("sub0"), jax.tree_util.DictKey(name))
            leaf = types.SimpleNamespace(shape=shape, ndim=len(shape))
            assert shd.serving_cache_pspec(name, shape, tp) == \
                tuple(jshd.serving_cache_pspec(path, leaf, tp)), (name, shape)
    cfg = get_config("glm4_9b", smoke=True)
    import dataclasses
    cfg = dataclasses.replace(cfg, num_kv_heads=K, num_heads=K * 2)
    jcfg = dataclasses.replace(jax_get_config("glm4_9b", smoke=True),
                               num_kv_heads=K, num_heads=K * 2)
    for kv in ("bf16", "int8"):
        if K % tp:
            with pytest.raises(ValueError, match="not divisible"):
                block_bytes(cfg, 16, tp=tp, kv_dtype=kv)
        else:
            assert block_bytes(cfg, 16, tp=tp, kv_dtype=kv) == \
                jax_block_bytes(jcfg, 16, tp=tp, kv_dtype=kv)


MESHES = [{"data": 1, "model": 1}, {"data": 2, "model": 4},
          {"data": 8, "model": 2}, {"model": 3}]


@pytest.mark.parametrize("mesh", MESHES, ids=[str(m) for m in MESHES])
@pytest.mark.parametrize("arch", ["glm4_9b", "qwen3_moe_30b_a3b",
                                  "zamba2_2p7b"])
def test_training_rules_match_reference(arch, mesh):
    """``serving_tp``, ``make_rules`` and ``resolve_spec`` over a mesh
    shape against the JAX package's (its mesh given as the axis names and
    shape it reads)."""
    jmesh = types.SimpleNamespace(axis_names=tuple(mesh), shape=mesh)
    assert shd.serving_tp(mesh) == jshd.serving_tp(jmesh)
    for fsdp, ff2d in ((False, False), (True, False), (True, True)):
        ours = shd.make_rules(get_config(arch),
                              ParallelConfig(fsdp=fsdp, expert_ff_2d=ff2d))
        want = jshd.make_rules(jax_get_config(arch),
                               JaxParallelConfig(fsdp=fsdp,
                                                 expert_ff_2d=ff2d))
        assert ours == want
        for shape, logical in (((4096, 32, 128), ("embed", "heads",
                                                  "head_dim")),
                               ((128, 2048, 768), ("experts", "embed",
                                                   "expert_ff")),
                               ((151552, 4096), ("vocab", "embed")),
                               ((6, 4096, 2, 128), ("layers", "embed",
                                                    "kv_heads", None)),
                               ((96, 7), ("ff", "ff"))):
            assert shd.resolve_spec(shape, logical, ours, mesh) == \
                tuple(jshd.resolve_spec(shape, logical, want, jmesh))
    assert tuple(P()) == ()

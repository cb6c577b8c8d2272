"""The port's paged attention and gather against the JAX package.

On the CPU the port runs the plain versions: ``ref.paged_attention_ref``
(decode) and ``paged_chunk_attention_xla`` (chunk), held here against the
JAX package's oracles (``repro.kernels.ref``) and XLA chunk path on the
cases of ``tests/test_serving.py``. The JAX package's Pallas paged kernels
do not run under ``interpret=True`` on this toolchain (ROADMAP.md queue
3), so they are not the reference here; the hand-written CUDA kernels are
held against the plain versions on the card (``chip_smoke.py``, and the
CUDA-only test at the end of this file)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import embedding as jemb_k
from repro.kernels import ref as jref
from repro.models import attention as jatt
from repro_torch.kernels import embedding as temb_k
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tatt
import torch_cpu  # noqa: F401  (one torch thread)

TOL = {"float32": 1e-5, "bfloat16": 1e-2}
JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# B, H, K, hd, block_size, blocks_per_seq, window, cap, dtype
# (tests/test_serving.py PAGED_CASES: GQA, cap, MHA + window, MQA, both)
PAGED_CASES = [
    (3, 4, 2, 16, 8, 4, None, None, "float32"),
    (2, 8, 2, 32, 16, 3, None, 50.0, "bfloat16"),
    (2, 6, 6, 16, 8, 5, 12, None, "float32"),
    (1, 8, 1, 64, 8, 4, None, None, "bfloat16"),
    (2, 4, 2, 64, 16, 2, 8, 30.0, "bfloat16"),
]

# B, H, K, hd, block_size, blocks_per_seq, C, window, cap, dtype
# (tests/test_serving.py CHUNK_CASES)
CHUNK_CASES = [
    (3, 4, 2, 16, 8, 4, 1, None, None, "float32"),
    (2, 8, 2, 32, 16, 3, 16, None, 50.0, "bfloat16"),
    (2, 6, 6, 16, 8, 5, 20, None, None, "float32"),
    (2, 6, 2, 16, 8, 5, 20, 12, None, "float32"),
    (1, 8, 1, 64, 8, 4, 20, None, None, "bfloat16"),
]


def _both(a, dtype):
    """numpy -> (jax array, torch tensor) of the same values in dtype."""
    j = jnp.asarray(a, jnp.float32).astype(JD[dtype]) if a.dtype.kind == "f" \
        else jnp.asarray(a)
    t = torch.from_numpy(np.asarray(a, np.float32)).to(TD[dtype]) \
        if a.dtype.kind == "f" else torch.from_numpy(a)
    return j, t


def _paged_case(rng, B, H, K, hd, bs, nblk, C=None):
    """Random pools + disjoint per-seq tables + ctx (+ q_lens for a chunk),
    as numpy. Shapes as in tests/test_serving.py."""
    N = 1 + B * nblk
    qshape = (B, H, hd) if C is None else (B, C, H, hd)
    q = rng.normal(0, 1, qshape)
    kp = rng.normal(0, 1, (N, bs, K, hd))
    vp = rng.normal(0, 1, (N, bs, K, hd))
    bt = rng.permutation(np.arange(1, N))[:B * nblk].reshape(B, nblk) \
        .astype(np.int32)
    if C is None:
        ctx = rng.integers(1, nblk * bs + 1, (B,)).astype(np.int32)
        return q, kp, vp, bt, ctx
    qlen = rng.integers(0, C + 1, (B,))
    qlen[0] = C                     # always one full chunk in the batch
    ctx = np.array([rng.integers(ql, nblk * bs + 1) if ql else 0
                    for ql in qlen], np.int32)
    return q, kp, vp, bt, ctx, qlen.astype(np.int32)


def _close(j, t, dtype):
    np.testing.assert_allclose(np.asarray(j, np.float32), t.float().numpy(),
                               atol=TOL[dtype])


@pytest.mark.parametrize("case", PAGED_CASES)
def test_decode_plain_vs_reference(case):
    B, H, K, hd, bs, nblk, window, cap, dt = case
    rng = np.random.default_rng(PAGED_CASES.index(case))
    arrs = [_both(a, dt) for a in _paged_case(rng, B, H, K, hd, bs, nblk)]
    (qj, qt), (kj, kt), (vj, vt), (bj, btt), (cj, ct) = arrs
    o_j = jref.paged_attention_ref(qj, kj, vj, bj, cj, window=window, cap=cap)
    o_t = ops.paged_attention(qt, kt, vt, btt, ct, window=window, cap=cap)
    assert o_t.dtype == TD[dt] and o_t.shape == (B, H, hd)
    _close(o_j, o_t, dt)
    # ops on CPU tensors is exactly the plain version
    assert torch.equal(o_t, tref.paged_attention_ref(
        qt, kt, vt, btt, ct, window=window, cap=cap))


@pytest.mark.parametrize("case", CHUNK_CASES)
def test_chunk_plain_vs_reference(case):
    B, H, K, hd, bs, nblk, C, window, cap, dt = case
    rng = np.random.default_rng(10 + CHUNK_CASES.index(case))
    arrs = [_both(a, dt) for a in _paged_case(rng, B, H, K, hd, bs, nblk, C)]
    (qj, qt), (kj, kt), (vj, vt), (bj, btt), (cj, ct), (lj, lt) = arrs
    # the XLA chunk path, row for row (padding rows included: both emit
    # the same unmasked-past-ctx values there)
    o_j = jatt.paged_chunk_attention_xla(qj, kj, vj, bj, cj, lj,
                                         window=window, cap=cap)
    o_t = ops.paged_prefill_attention(qt, kt, vt, btt, ct, lt,
                                      window=window, cap=cap)
    assert o_t.dtype == TD[dt] and o_t.shape == (B, C, H, hd)
    _close(o_j, o_t, dt)
    # the zero-padding oracle
    r_j = jref.paged_prefill_attention_ref(qj, kj, vj, bj, cj, lj,
                                           window=window, cap=cap)
    r_t = tref.paged_prefill_attention_ref(qt, kt, vt, btt, ct, lt,
                                           window=window, cap=cap)
    _close(r_j, r_t, dt)
    for b in range(B):
        assert (r_t[b, int(lt[b]):] == 0).all()


def test_inactive_and_padding_rows_are_zero():
    rng = np.random.default_rng(5)
    q, kp, vp, bt, _ = _paged_case(rng, 2, 4, 2, 16, 8, 3)
    q, kp, vp = (torch.from_numpy(a).float() for a in (q, kp, vp))
    bt = torch.from_numpy(bt)
    o = tref.paged_attention_ref(q, kp, vp, bt,
                                 torch.tensor([0, 5], dtype=torch.int32))
    assert (o[0] == 0).all() and torch.isfinite(o).all()
    qc = torch.from_numpy(rng.normal(0, 1, (2, 8, 4, 16))).float()
    oc = tref.paged_prefill_attention_ref(
        qc, kp, vp, bt, torch.tensor([10, 0], dtype=torch.int32),
        torch.tensor([3, 0], dtype=torch.int32))
    assert (oc[0, 3:] == 0).all() and (oc[1] == 0).all()
    assert torch.isfinite(oc).all()


def test_update_paged_cache_bit_equal():
    """Decode and chunk KV scatters write the same bytes as the JAX
    package's (the trash block 0 aside: duplicate writes land there in an
    unspecified order in both)."""
    rng = np.random.default_rng(6)
    N, bs, K, hd, B, nb, C = 9, 4, 2, 16, 3, 2, 6
    pages = rng.normal(0, 1, (N, bs, K, hd))
    bt = np.array([[1, 2], [3, 4], [0, 0]], np.int32)     # slot 2 idle
    pj, pt = _both(pages, "bfloat16")
    new = rng.normal(0, 1, (B, 1, K, hd))
    pos = np.array([5, 2, 0], np.int32)
    nj, nt = _both(new, "bfloat16")
    out_j = jatt.update_paged_cache(pj, nj, jnp.asarray(bt), jnp.asarray(pos))
    out_t = tatt.update_paged_cache(pt.clone(), nt, torch.from_numpy(bt),
                                    torch.from_numpy(pos))
    np.testing.assert_array_equal(np.asarray(out_j, np.float32)[1:],
                                  out_t.float().numpy()[1:])
    chunk = rng.normal(0, 1, (B, C, K, hd))
    q_start = np.array([1, 0, 0], np.int32)
    q_lens = np.array([6, 3, 0], np.int32)
    cj, ct = _both(chunk, "bfloat16")
    out_j = jatt.update_paged_cache_chunk(pj, cj, jnp.asarray(bt),
                                          jnp.asarray(q_start),
                                          jnp.asarray(q_lens))
    base = pt.clone()
    out_t = tatt.update_paged_cache_chunk(base, ct, torch.from_numpy(bt),
                                          torch.from_numpy(q_start),
                                          torch.from_numpy(q_lens))
    assert out_t is base                       # updated in place
    np.testing.assert_array_equal(np.asarray(out_j, np.float32)[1:],
                                  out_t.float().numpy()[1:])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_plain_vs_pallas_interpret(dtype):
    rng = np.random.default_rng(7)
    table = rng.normal(0, 1, (40, 64))
    ids = rng.integers(0, 40, (3, 5)).astype(np.int32)
    tj, tt = _both(table, dtype)
    o_j = jemb_k.gather(tj, jnp.asarray(ids), interpret=True)
    o_t = ops.embedding_gather(tt, torch.from_numpy(ids))
    assert o_t.shape == (3, 5, 64)
    np.testing.assert_array_equal(np.asarray(o_j, np.float32),
                                  o_t.float().numpy())


def test_kernel_wrappers_refuse_cpu_tensors_and_unported_options():
    """A wrapper launches its kernel or raises: CPU tensors never reach a
    hidden fallback, the partials' options included (decode and chunk
    take block_mask, return_lse and any pages_per_compute_block), and
    the packed kernel's missing partials are named."""
    rng = np.random.default_rng(8)
    q, kp, vp, bt, ctx = (torch.from_numpy(a) for a in
                          _paged_case(rng, 2, 4, 2, 16, 8, 3))
    q, kp, vp = q.bfloat16(), kp.bfloat16(), vp.bfloat16()
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_attention(q, kp, vp, bt, ctx)
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_prefill_attention(q[:, None], kp, vp, bt, ctx,
                                    torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        temb_k.gather(kp[0, 0], torch.zeros(3, dtype=torch.int32))
    for kw in ({"pages_per_compute_block": 2}, {"block_mask": bt},
               {"return_lse": True}):
        with pytest.raises(ValueError, match="CUDA"):
            tpa.paged_attention(q, kp, vp, bt, ctx, **kw)
        with pytest.raises(ValueError, match="CUDA"):
            tpa.paged_prefill_attention(q[:, None], kp, vp, bt, ctx,
                                        torch.ones(2, dtype=torch.int32),
                                        **kw)
    se = torch.tensor([0, 1], dtype=torch.int32)
    for kw in ({"block_mask": bt}, {"return_lse": True}):
        with pytest.raises(NotImplementedError,
                           match=r"ROADMAP\.md queue 2 item 3"):
            tpa.ragged_paged_prefill_attention(q, kp, vp, bt, ctx, se,
                                               se + 1, **kw)
    # a quantized pool's scale pools must be fp32 (N, bs, K, 1): a wrong
    # shape, a wrong dtype or a missing one is refused before any launch
    k8, v8 = kp.to(torch.int8), vp.to(torch.int8)
    good = torch.ones(kp.shape[:3] + (1,))
    for ks in (good[..., 0], good.double(), None):
        with pytest.raises(ValueError, match="k_scale"):
            tpa.paged_attention(q, k8, v8, bt, ctx, k_scale=ks,
                                v_scale=good)
    with pytest.raises(ValueError, match="k_scale"):
        tpa.paged_attention(q, kp, vp, bt, ctx, k_scale=good, v_scale=good)
    assert not sum(tpa.paged_attention.launches.values())
    assert temb_k.gather.launches == 0


# the CHUNK_CASES shapes at the head dims the kernels take (tpa.HEAD_DIMS)
CUDA_CASES = [
    (2, 8, 2, 16, 16, 3, 16, None, 50.0),
    (2, 6, 2, 128, 8, 5, 20, 12, None),
    (1, 8, 1, 128, 8, 4, 20, None, None),
]


# decode == chunk(C=1) at the kernel's step (64 keys) and segment (256
# keys) edges, four segments and three keys, one key, an inactive slot;
# (H, K, hd, block_size, window, cap), each over bf16/int8/fp8 pools
EDGE_CTX = [63, 65, 255, 257, 1027, 64, 1, 0]
CUDA_EDGE_CASES = [(H, K, hd, bs, w, cap)
                   for H, K, hd in ((32, 2, 128), (32, 32, 80), (4, 2, 16))
                   for bs in (8, 32)
                   for w, cap in ((None, None), (50, 30.0))]


def _assert_rows_close(a, b, tol=1e-2):
    """Each output row (one head's hd values) within ``tol`` relative to
    its own norm, and every value within ``tol`` absolute."""
    a, b = a.float().flatten(0, -2), b.float().flatten(0, -2)
    torch.testing.assert_close(a, b, atol=tol, rtol=0)
    rel = torch.nan_to_num((a - b).norm(dim=-1) / b.norm(dim=-1), nan=0.0)
    assert float(rel.max()) <= tol, float(rel.max())


@pytest.mark.parametrize("case", CUDA_CASES)
def test_cuda_kernels_vs_plain(case):
    """Kernel vs plain on the card (bf16, 1e-2 per row); chunk(C=1) ==
    decode bit for bit; padding rows and ctx=0 rows exact zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    B, H, K, hd, bs, nblk, C, window, cap = case
    rng = np.random.default_rng(9)
    dev = "cuda"
    q, kp, vp, bt, ctx, qlen = (torch.from_numpy(a).to(dev) for a in
                                _paged_case(rng, B, H, K, hd, bs, nblk, C))
    q, kp, vp = q.bfloat16(), kp.bfloat16(), vp.bfloat16()
    o_k = tpa.paged_prefill_attention(q, kp, vp, bt, ctx, qlen,
                                      window=window, cap=cap)
    o_p = tref.paged_prefill_attention_ref(q, kp, vp, bt, ctx, qlen,
                                           window=window, cap=cap)
    _assert_rows_close(o_k, o_p)
    for b in range(B):
        assert (o_k[b, int(qlen[b]):] == 0).all()
    q1 = q[:, 0].contiguous()
    ctx1 = torch.where(qlen > 0, ctx - qlen + 1, 0).to(torch.int32)
    o_d = tpa.paged_attention(q1, kp, vp, bt, ctx1, window=window, cap=cap)
    o_c = tpa.paged_prefill_attention(q1[:, None].contiguous(), kp, vp, bt,
                                      ctx1, torch.ones_like(qlen),
                                      window=window, cap=cap)
    assert torch.equal(o_c[:, 0], o_d)
    table = torch.from_numpy(rng.normal(0, 1, (50, 64))).bfloat16().to(dev)
    ids = torch.from_numpy(rng.integers(0, 50, (4, 3))).to(torch.int32) \
        .to(dev)
    assert torch.equal(temb_k.gather(table, ids), table[ids.long()])


@pytest.mark.parametrize("case", CUDA_EDGE_CASES)
def test_cuda_decode_equals_chunk_at_step_and_segment_edges(case):
    """On the card, at contexts on both sides of the kernel's 64-key steps
    and 256-key segments: decode == chunk(C=1) bit for bit over every
    pool dtype, ctx=0 rows exact zeros, decode within 1e-2 of plain."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.models.quant import quantize_kv
    H, K, hd, bs, window, cap = case
    rng = np.random.default_rng(30 + CUDA_EDGE_CASES.index(case))
    B, nb = len(EDGE_CTX), -(-max(EDGE_CTX) // bs)
    q, kp, vp, bt, _ = (torch.from_numpy(a).cuda() for a in
                        _paged_case(rng, B, H, K, hd, bs, nb))
    ctx = torch.tensor(EDGE_CTX, dtype=torch.int32, device="cuda")
    q, kp, vp = q.bfloat16(), kp.bfloat16(), vp.bfloat16()
    ones = torch.ones(B, dtype=torch.int32, device="cuda")
    for kv in ("bf16", "int8", "fp8"):
        kw = dict(window=window, cap=cap)
        k, v = kp, vp
        if kv != "bf16":
            (k, ks), (v, vs) = quantize_kv(kp, kv), quantize_kv(vp, kv)
            kw.update(k_scale=ks, v_scale=vs)
        o_d = tpa.paged_attention(q, k, v, bt, ctx, **kw)
        o_c = tpa.paged_prefill_attention(q[:, None].contiguous(), k, v, bt,
                                          ctx, ones, **kw)
        assert torch.equal(o_c[:, 0], o_d), kv
        assert (o_d[EDGE_CTX.index(0)] == 0).all(), kv
        _assert_rows_close(o_d, tref.paged_attention_ref(q, k, v, bt, ctx,
                                                         **kw))


@pytest.mark.parametrize("case", PAGED_CASES)
def test_dense_attention_ref_vs_reference_and_paged(case):
    """``attention_ref`` against the JAX oracle, and the paged decode
    oracle against it over the densified pages (as tests/test_serving.py
    checks the JAX pair)."""
    B, H, K, hd, bs, nblk, window, cap, dt = case
    rng = np.random.default_rng(20 + PAGED_CASES.index(case))
    q, kp, vp, bt, ctx = _paged_case(rng, B, H, K, hd, bs, nblk)
    o_p = tref.paged_attention_ref(*(torch.from_numpy(a) for a in
                                     (q, kp, vp, bt, ctx)),
                                   window=window, cap=cap).numpy()
    for b in range(B):
        S = int(ctx[b])
        k = kp[bt[b]].reshape(-1, K, hd)[None, :S]
        v = vp[bt[b]].reshape(-1, K, hd)[None, :S]
        qb = q[b:b + 1, None]
        o_t = tref.attention_ref(*(torch.from_numpy(a) for a in (qb, k, v)),
                                 window=window, cap=cap, q_offset=S - 1)
        o_j = jref.attention_ref(*(jnp.asarray(a) for a in (qb, k, v)),
                                 window=window, cap=cap, q_offset=S - 1)
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-5)
        np.testing.assert_allclose(o_p[b], o_t.numpy()[0, 0], atol=1e-5)

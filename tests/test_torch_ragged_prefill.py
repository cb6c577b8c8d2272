"""Packed (ragged) prefill in the port against the JAX package.

On the CPU the port runs the plain versions: ``update_paged_cache_ragged``
and ``ragged_chunk_attention_xla`` (with the scatter before it for the
fused op), held here against the JAX package's XLA paths and its oracle
``kernels.ref.ragged_paged_prefill_attention_ref`` over window, softcap
and empty pack slots. The JAX package's Pallas paged kernels do not run
under ``interpret=True`` on this toolchain (ROADMAP.md queue 3), so they
are not the reference here; the CUDA kernel is held against the plain
version on the card (the CUDA-only test at the end, and
``chip_smoke.py``). Then the scheduler's packed plans, the packed forward
and the engine at ``prefill_pack`` > 1 against the JAX package, and the
JAX package's own packing invariants inside the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ParallelConfig, get_config as jax_get_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import api as japi
from repro.models import attention as jatt
from repro.models import transformer as jtf
from repro.serving import InferenceEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving.engine import pack_ragged as jax_pack
from repro.serving.engine import unpack_ragged as jax_unpack
from repro.serving.kv_cache import BlockManager as JBM
from repro.serving.kv_cache import init_paged_cache as jax_init_paged_cache
from repro.serving.scheduler import Request as JReq
from repro.serving.scheduler import Scheduler as JSched
from repro_torch.config import get_config
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tatt
from repro_torch.models import transformer as ttf
from repro_torch.models.api import params_from_jax
from repro_torch.serving import InferenceEngine, Request
from repro_torch.serving.engine import pack_ragged, unpack_ragged
from repro_torch.serving.kv_cache import BlockManager, init_paged_cache
from repro_torch.serving.scheduler import Scheduler
import torch_cpu  # noqa: F401  (one torch thread)

TOL = {"float32": 1e-5, "bfloat16": 1e-2}
JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BF16_TOL = 1e-2

# H, K, hd, block_size, blocks_per_seq, T, q_lens, ctx_lens, window, cap,
# dtype: GQA; an empty pack slot between two sequences with softcap; a
# window with trailing empty slots; one sequence filling T (MQA); window
# and softcap together
RAGGED_CASES = [
    (4, 2, 16, 8, 4, 24, [5, 7, 3], [12, 7, 30], None, None, "float32"),
    (8, 2, 32, 16, 3, 32, [10, 0, 13], [40, 0, 13], None, 50.0, "bfloat16"),
    (6, 2, 16, 8, 5, 20, [6, 6, 0, 0], [20, 33, 0, 0], 12, None, "float32"),
    (8, 1, 64, 8, 4, 16, [16], [32], None, None, "bfloat16"),
    (4, 2, 64, 16, 2, 24, [9, 11], [20, 11], 8, 30.0, "bfloat16"),
]


def to_torch(a):
    """A numpy / jax array -> torch tensor with the same bits (bf16 and fp8
    through their raw bytes)."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(a)


def both(a, dtype=None):
    """numpy -> (jax array, torch tensor) of the same values; floats are
    cast to ``dtype`` first."""
    j = jnp.asarray(a)
    if dtype is not None:
        j = jnp.asarray(a, jnp.float32).astype(JD[dtype])
    return j, to_torch(j)


def ragged_case(rng, H, K, hd, bs, nblk, T, q_lens, ctx_lens):
    """Random pools, disjoint per-sequence tables and the packed layout,
    as numpy: (q, k_pages, v_pages, tables, ctx, starts, ends, row_seq)."""
    S = len(q_lens)
    N = 1 + S * nblk
    q = rng.normal(0, 1, (T, H, hd))
    kp = rng.normal(0, 1, (N, bs, K, hd))
    vp = rng.normal(0, 1, (N, bs, K, hd))
    bt = rng.permutation(np.arange(1, N))[:S * nblk].reshape(S, nblk) \
        .astype(np.int32)
    _, seq, starts, ends = pack_ragged([np.zeros(n) for n in q_lens], T, S)
    return (q, kp, vp, bt, np.asarray(ctx_lens, np.int32), starts, ends,
            seq)


def owned(starts, ends, T):
    t = np.arange(T)
    return ((t[:, None] >= starts[None]) & (t[:, None] < ends[None])) \
        .any(axis=1)


def test_pack_unpack_match_reference():
    rng = np.random.default_rng(0)
    for lens in ([5, 0, 7], [16], [3, 4, 5, 4], []):
        rows = [rng.integers(0, 100, n).astype(np.int32) for n in lens]
        ours = pack_ragged(rows, 16, 4)
        ref = jax_pack(rows, 16, 4)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)
        back = unpack_ragged(*ours[:1], ours[2], ours[3], len(rows))
        assert [r.tolist() for r in back] == [r.tolist() for r in rows]
        assert [r.tolist() for r in back] == [
            r.tolist() for r in jax_unpack(ref[0], ref[2], ref[3],
                                           len(rows))]
    with pytest.raises(ValueError, match="do not fit"):
        pack_ragged([np.zeros(9), np.zeros(9)], 16, 4)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_update_paged_cache_ragged_bit_equal(dtype):
    """The packed KV scatter writes the same bytes as the JAX package's,
    in place (the trash block 0 aside: pad rows land there in an
    unspecified order in both)."""
    rng = np.random.default_rng(1)
    _, kp, _, bt, ctx, st, en, seq = ragged_case(
        rng, 4, 2, 16, 4, 3, 16, [5, 0, 6], [9, 0, 12])
    pj, pt = both(kp, dtype)
    nj, nt = both(rng.normal(0, 1, (1, 16, 2, 16)), dtype)
    meta = [both(a) for a in (bt, ctx, st, en, seq)]
    out_j = jatt.update_paged_cache_ragged(pj, nj, *(m[0] for m in meta))
    base = pt.clone()
    out_t = tatt.update_paged_cache_ragged(base, nt, *(m[1] for m in meta))
    assert out_t is base
    np.testing.assert_array_equal(np.asarray(out_j, np.float32)[1:],
                                  out_t.float().numpy()[1:])
    assert not torch.equal(out_t[1:], pt[1:])        # something was written


@pytest.mark.parametrize("case", RAGGED_CASES)
def test_ragged_plain_vs_reference(case):
    H, K, hd, bs, nblk, T, q_lens, ctx, window, cap, dt = case
    rng = np.random.default_rng(10 + RAGGED_CASES.index(case))
    q, kp, vp, bt, ctx, st, en, seq = ragged_case(rng, H, K, hd, bs, nblk,
                                                  T, q_lens, ctx)
    (qj, qt), (kj, kt), (vj, vt) = (both(a, dt) for a in (q, kp, vp))
    meta = [both(a) for a in (bt, ctx, st, en, seq)]
    mj, mt = [m[0] for m in meta], [m[1] for m in meta]
    kw = dict(window=window, cap=cap)
    o_j = jatt.ragged_chunk_attention_xla(qj, kj, vj, *mj, **kw)
    o_t = ops.ragged_paged_prefill_attention(qt, kt, vt, *mt, **kw)
    assert o_t.dtype == TD[dt] and o_t.shape == (T, H, hd)
    np.testing.assert_allclose(np.asarray(o_j, np.float32),
                               o_t.float().numpy(), atol=TOL[dt])
    r_j = jref.ragged_paged_prefill_attention_ref(qj, kj, vj, *mj, **kw)
    r_t = tref.ragged_paged_prefill_attention_ref(qt, kt, vt, *mt, **kw)
    np.testing.assert_allclose(np.asarray(r_j, np.float32),
                               r_t.float().numpy(), atol=TOL[dt])
    np.testing.assert_allclose(o_t.float().numpy(), r_t.float().numpy(),
                               atol=TOL[dt])
    pad = ~owned(st, en, T)
    assert (o_t[torch.from_numpy(pad)] == 0).all()
    assert (r_t[torch.from_numpy(pad)] == 0).all()


def test_ragged_plain_single_sequence_equals_chunk():
    """S == 1 is the single-chunk path in another layout: the same bits on
    every valid row."""
    rng = np.random.default_rng(3)
    q, kp, vp, bt, ctx, st, en, seq = ragged_case(
        rng, 4, 2, 16, 8, 4, 20, [13], [29])
    q, kp, vp = (torch.from_numpy(a).bfloat16() for a in (q, kp, vp))
    bt, ctx, st, en, seq = map(torch.from_numpy, (bt, ctx, st, en, seq))
    o_r = tatt.ragged_chunk_attention_xla(q, kp, vp, bt, ctx, st, en, seq,
                                          window=9, cap=20.0)
    o_c = tatt.paged_chunk_attention_xla(q[None], kp, vp, bt, ctx, en - st,
                                         window=9, cap=20.0)
    assert torch.equal(o_r[:13], o_c[0, :13])
    assert (o_r[13:] == 0).all()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_fused_plain_op_equals_scatter_then_attend(dtype):
    """``ops.ragged_prefill_update_attend`` on the CPU: the pools it
    returns are the ones it was given, updated to the bytes of a separate
    scatter, and its output is the attention over them; both match the
    JAX package's fused op (XLA path)."""
    rng = np.random.default_rng(4)
    T = 24
    q, kp, vp, bt, ctx, st, en, seq = ragged_case(
        rng, 4, 2, 16, 8, 4, T, [5, 0, 9, 6], [12, 0, 9, 30])
    kn, vn = (rng.normal(0, 1, (T, 2, 16)) for _ in range(2))
    (qj, qt), (kj, kt), (vj, vt), (knj, knt), (vnj, vnt) = (
        both(a, dtype) for a in (q, kp, vp, kn, vn))
    meta = [both(a) for a in (bt, ctx, st, en, seq)]
    mj, mt = [m[0] for m in meta], [m[1] for m in meta]
    k1, v1 = kt.clone(), vt.clone()
    o, kc, vc = ops.ragged_prefill_update_attend(qt, knt, vnt, k1, v1, *mt,
                                                 window=10)
    assert kc is k1 and vc is v1
    k2 = tatt.update_paged_cache_ragged(kt.clone(), knt[None], *mt)
    v2 = tatt.update_paged_cache_ragged(vt.clone(), vnt[None], *mt)
    assert torch.equal(kc[1:], k2[1:]) and torch.equal(vc[1:], v2[1:])
    assert torch.equal(o, tatt.ragged_chunk_attention_xla(
        qt, k2, v2, *mt, window=10))
    o_j, kc_j, vc_j = jops.ragged_prefill_update_attend(
        qj, knj, vnj, kj, vj, *mj, window=10)
    np.testing.assert_array_equal(np.asarray(kc_j, np.float32)[1:],
                                  kc.float().numpy()[1:])
    np.testing.assert_array_equal(np.asarray(vc_j, np.float32)[1:],
                                  vc.float().numpy()[1:])
    np.testing.assert_allclose(np.asarray(o_j, np.float32),
                               o.float().numpy(), atol=TOL[dtype])


def _plan_key(plan):
    return ([(s, r.rid) for s, r in plan.decodes],
            [(s, r.rid, n) for s, r, n in plan.chunks],
            list(plan.copies), plan.admitted, plan.scheduled_tokens)


@pytest.mark.parametrize("pack", [2, 4])
def test_scheduler_packed_plans_match_reference(pack):
    """Same arrivals and fake model (token = step-dependent constant) in
    both schedulers at prefill_pack > 1: every step's plan, preemptions
    and cache hits agree, and some step carries several chunks."""
    rng = np.random.default_rng(pack)
    base = rng.integers(0, 50, 12).astype(np.int32)
    prompts = [base.copy(), rng.integers(0, 50, 7).astype(np.int32),
               np.concatenate([base, rng.integers(0, 50, 5)
                               .astype(np.int32)]),
               rng.integers(0, 50, 9).astype(np.int32),
               rng.integers(0, 50, 3).astype(np.int32), base.copy()]
    arrivals = [0, 0, 0, 2, 2, 5]
    runs = []
    for BM, Sched, Req in ((JBM, JSched, JReq),
                           (BlockManager, Scheduler, Request)):
        bm = BM(16, 4)
        s = Sched(bm, 4, 8, 4 + 10, 10, prefill_pack=pack)
        reqs = [Req(p.copy(), max_new=6, rid=2000 + i)
                for i, p in enumerate(prompts)]
        plans, step, pending = [], 0, list(zip(arrivals, reqs))
        while pending or s.has_work:
            while pending and pending[0][0] <= step:
                s.add(pending.pop(0)[1])
            plan = s.schedule()
            plans.append(_plan_key(plan))
            for slot, r in plan.decodes:
                r.num_computed += 1
                r.out.append((step * 7 + r.rid) % 50)
                s.note_progress(r)
                if r.done:
                    s.retire(slot)
            for slot, r, n in plan.chunks:
                r.num_computed += n
                if r.num_computed == r.context_len:
                    r.out.append((step * 7 + r.rid) % 50)
                    s.note_progress(r)
                    if r.done:
                        s.retire(slot)
                else:
                    s.note_progress(r)
            step += 1
            assert step < 500
        runs.append((plans, s.n_preemptions, s.cache_hit_tokens,
                     [r.out for r in reqs]))
    assert runs[0] == runs[1]
    assert max(len(p[1]) for p in runs[1][0]) >= 2          # packed steps
    assert runs[1][1] > 0 and runs[1][2] > 0    # preemption and prefix hits


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_prefill_chunk_ragged_matches_reference(kv_dtype):
    """The packed forward over two layers, with the pools written by it,
    against the JAX package's ``prefill_chunk_ragged`` on the same
    parameters, tokens, tables and (zero) pools."""
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    jcfg = jax_get_config("glm4_9b", smoke=True)
    tcfg = get_config("glm4_9b", smoke=True)
    with jax.set_mesh(mesh):
        pf, _ = japi.init_model(jcfg, jax.random.key(0))
        tree = jax.tree.map(lambda x: np.asarray(x.astype(jnp.bfloat16)), pf)
    tp = params_from_jax(tree, tcfg, "cpu")
    jp = jax.tree.map(jnp.asarray, tree)
    N, bs, T = 9, 8, 24
    jcache = jax_init_paged_cache(jcfg, N, bs, kv_dtype=kv_dtype)
    tcache = init_paged_cache(tcfg, N, bs, "cpu", kv_dtype)
    assert sorted(tcache) == sorted(jcache["sub0"])
    rng = np.random.default_rng(5)
    lens, starts_at = [7, 0, 11], [0, 0, 4]      # chunk 2 continues a row
    rows = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
            for n in lens]
    tok, seq, st, en = pack_ragged(rows, T, 3)
    pos = pack_ragged([np.arange(a, a + n, dtype=np.int32)
                       for a, n in zip(starts_at, lens)], T, 3)[0]
    b = {"tokens": tok[None], "positions": pos[None], "starts": st,
         "ends": en, "row_seq": seq,
         "block_tables": np.array([[1, 2, 0], [0, 0, 0], [3, 4, 5]],
                                  np.int32),
         "ctx_lens": np.array([7, 0, 15], np.int32)}
    with jax.set_mesh(mesh):
        lj, jcache = jtf.prefill_chunk_ragged(
            jp, jcache, {k: jnp.asarray(v) for k, v in b.items()}, jcfg,
            ParallelConfig(remat="none"))
    lt, tcache = ttf.prefill_chunk_ragged(
        tp, tcache, {k: torch.from_numpy(v) for k, v in b.items()}, tcfg)
    lj = np.asarray(lj)[:, :jcfg.vocab_size]
    lt = lt.numpy()[:, :tcfg.vocab_size]
    for s in (0, 2):                             # slot 1 is empty
        np.testing.assert_allclose(lj[s], lt[s], atol=5e-2, rtol=5e-2)
        assert lj[s].argmax() == lt[s].argmax()
    jc = jcache["sub0"]
    for name in ("k", "v"):
        # quantized pools are compared dequantized: the two frameworks'
        # bf16 activations differ in a last bit here and there, which can
        # move a row's absmax scale and so every code of that row
        ref, ours = np.asarray(jc[name], np.float32), tcache[name].float()
        if kv_dtype != "bf16":
            ref = ref * np.asarray(jc[f"{name}_scale"])
            ours = ours * tcache[f"{name}_scale"]
        np.testing.assert_allclose(ref[:, 1:], ours.numpy()[:, 1:],
                                   atol=5e-2, rtol=5e-2)


# ---------------------------------------------------------------------------
# the engine at prefill_pack > 1
# ---------------------------------------------------------------------------

# max_batch 4, 16-token blocks, 24-row chunk rows shared by up to 4 chunks
PACK = dict(max_batch=4, block_size=16, max_len=96,
            max_num_batched_tokens=4 + 24)


@pytest.fixture(scope="module")
def setup():
    cfg = jax_get_config("glm4_9b", smoke=True)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    with jax.set_mesh(mesh):
        pf, _ = japi.init_model(cfg, jax.random.key(0))
        tree = jax.tree.map(lambda x: np.asarray(x.astype(jnp.bfloat16)), pf)
    tcfg = get_config("glm4_9b", smoke=True)
    rng = np.random.default_rng(12)
    prefix = rng.integers(0, cfg.vocab_size, 32).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 9)
                               .astype(np.int32)]),
               rng.integers(0, cfg.vocab_size, 11).astype(np.int32),
               rng.integers(0, cfg.vocab_size, 30).astype(np.int32),
               np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 4)
                               .astype(np.int32)]),
               rng.integers(0, cfg.vocab_size, 6).astype(np.int32)]
    return cfg, mesh, tree, tcfg, prompts


def run_port(setup, prompts, arrivals=None, max_new=12, **kw):
    """Serve on the CPU; returns (engine, token lists, most chunks any
    step carried)."""
    _, _, tree, tcfg, _ = setup
    eng = InferenceEngine(tcfg, device="cpu",
                          params=params_from_jax(tree, tcfg, "cpu"),
                          debug_invariants=True, **kw)
    widest = [0]
    schedule = eng.sched.schedule

    def counted():
        plan = schedule()
        widest[0] = max(widest[0], len(plan.chunks))
        return plan

    eng.sched.schedule = counted
    reqs = [Request(p.copy(), max_new=max_new) for p in prompts]
    outs = eng.run(reqs, arrival_steps=arrivals)
    return eng, [outs[r.rid].tolist() for r in reqs], widest[0]


def last_logits(params, cfg, tokens, kv_dtype="bf16"):
    """The port's fp32 logits after ``tokens``, by one monolithic chunk
    over ``kv_dtype`` pools."""
    n, bs = len(tokens), 16
    nb = -(-n // bs)
    cache = init_paged_cache(cfg, nb + 1, bs, "cpu", kv_dtype)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32)

    batch = {"tokens": i32([list(tokens)]), "q_start": i32([0]),
             "q_lens": i32([n]), "block_tables": i32([list(range(1, nb + 1))]),
             "ctx_lens": i32([n])}
    with torch.no_grad():
        lg, _ = ttf.prefill_chunk_paged(params, cache, batch, cfg)
    return lg[0, :cfg.vocab_size]


def assert_same_or_near_tie(eng, prompt, ours, ref):
    """Equal token streams, or a first difference at a near-tie of the
    port's bf16 logits (the two frameworks round bf16 activations at
    other places)."""
    if ours == ref:
        return
    i = next(j for j, (a, b) in enumerate(zip(ours, ref)) if a != b)
    lg = last_logits(eng.params, eng.cfg,
                     np.concatenate([prompt, np.asarray(ours[:i])]),
                     eng.kv_dtype)
    top2 = torch.topk(lg, 2)
    margin = float(top2.values[0] - top2.values[1])
    assert set(top2.indices.tolist()) == {ours[i], ref[i]}, (i, top2)
    assert margin < BF16_TOL, f"step {i}: margin {margin:.4g}"


def test_engine_packed_greedy_matches_reference(setup):
    cfg, mesh, tree, _, prompts = setup
    arrivals = [0, 0, 0, 3, 3]
    jeng = JaxEngine(cfg, mesh, params=jax.tree.map(jnp.asarray, tree),
                     debug_invariants=True, prefill_pack=4, **PACK)
    jreqs = [JaxRequest(p.copy(), max_new=12) for p in prompts]
    jouts = jeng.run(jreqs, arrival_steps=arrivals)
    eng, outs, widest = run_port(setup, prompts, arrivals, prefill_pack=4,
                                 **PACK)
    assert widest >= 2 and eng.stats["cache_hit_tokens"] > 0
    for p, ours, jr in zip(prompts, outs, jreqs):
        assert len(ours) == 12 and all(0 <= t < cfg.vocab_size for t in ours)
        assert_same_or_near_tie(eng, p, ours, jouts[jr.rid].tolist())
    if all(o == jouts[jr.rid].tolist() for o, jr in zip(outs, jreqs)):
        for key in ("cache_hit_tokens", "prefill_chunks", "steps", "tokens"):
            assert eng.stats[key] == jeng.stats[key], key


def test_packed_equals_unpacked(setup):
    prompts = setup[4]
    _, packed, widest = run_port(setup, prompts, prefill_pack=4, **PACK)
    assert widest >= 2
    _, unpacked, one = run_port(setup, prompts, prefill_pack=1, **PACK)
    assert one == 1
    assert packed == unpacked


def test_packed_prefix_hit_equals_cold(setup):
    prompts = setup[4]
    arrivals = [0, 0, 0, 4, 4]
    eng, hit, _ = run_port(setup, prompts, arrivals, prefill_pack=4, **PACK)
    assert eng.stats["cache_hit_tokens"] > 0
    eng, cold, _ = run_port(setup, prompts, arrivals, prefill_pack=4,
                            enable_prefix_caching=False, **PACK)
    assert eng.stats["cache_hit_tokens"] == 0
    assert hit == cold


def test_packed_preempted_equals_uninterrupted(setup):
    prompts = setup[4]
    eng, tight, widest = run_port(setup, prompts, max_new=20,
                                  prefill_pack=4, num_blocks=8, **PACK)
    assert eng.stats["preemptions"] >= 1 and widest >= 2
    _, free, _ = run_port(setup, prompts, max_new=20, prefill_pack=4, **PACK)
    assert tight == free


# ---------------------------------------------------------------------------
# the CUDA kernel (needs a card)
# ---------------------------------------------------------------------------


def assert_rows_close(a, b, tol=1e-2):
    """Each output row (one head's hd values) within ``tol`` relative to
    its own norm, and every value within ``tol`` absolute, ``tol``
    relative above a magnitude of 1 (one bf16 ulp there is 2^-8 of it)."""
    a, b = a.float().flatten(0, -2), b.float().flatten(0, -2)
    scaled = (a - b).abs() / b.abs().clamp(min=1.0)
    assert float(scaled.max()) <= tol, float(scaled.max())
    rel = torch.nan_to_num((a - b).norm(dim=-1) / b.norm(dim=-1), nan=0.0)
    assert float(rel.max()) <= tol, float(rel.max())


@pytest.mark.parametrize("case", [c for c in RAGGED_CASES if c[2] in
                                  tpa.HEAD_DIMS]
                         + [(32, 2, 128, 16, 8, 64, [30, 0, 20],
                             [128, 0, 20], None, None, "bfloat16")])
def test_cuda_ragged_kernel_vs_plain(case):
    """Kernel vs plain on the card (bf16, 1e-2 per row), with and without
    the fused write: pool bytes equal the separate scatter, S = 1 equals
    the chunk kernel bit for bit, and rows no sequence owns are zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    H, K, hd, bs, nblk, T, q_lens, ctx, window, cap, _ = case
    rng = np.random.default_rng(30)
    q, kp, vp, bt, ctx, st, en, seq = (
        torch.from_numpy(a).cuda() for a in
        ragged_case(rng, H, K, hd, bs, nblk, T, q_lens, ctx))
    q, kp, vp = q.bfloat16(), kp.bfloat16(), vp.bfloat16()
    kw = dict(window=window, cap=cap)
    o_k = tpa.ragged_paged_prefill_attention(q, kp, vp, bt, ctx, st, en, **kw)
    assert_rows_close(o_k, tatt.ragged_chunk_attention_xla(
        q, kp, vp, bt, ctx, st, en, seq, **kw))
    pad = torch.from_numpy(~owned(st.cpu().numpy(), en.cpu().numpy(), T))
    assert (o_k[pad.cuda()] == 0).all()
    kn = torch.randn((T, K, hd), device="cuda").bfloat16()
    vn = torch.randn((T, K, hd), device="cuda").bfloat16()
    k1, v1 = kp.clone(), vp.clone()
    o_w, _, _ = tpa.ragged_paged_prefill_attention(
        q, k1, v1, bt, ctx, st, en, k_new=kn, v_new=vn, **kw)
    k2 = tatt.update_paged_cache_ragged(kp.clone(), kn[None], bt, ctx, st,
                                        en, seq)
    v2 = tatt.update_paged_cache_ragged(vp.clone(), vn[None], bt, ctx, st,
                                        en, seq)
    assert torch.equal(k1[1:], k2[1:]) and torch.equal(v1[1:], v2[1:])
    assert torch.equal(o_w, tpa.ragged_paged_prefill_attention(
        q, k2, v2, bt, ctx, st, en, **kw))
    for s in range(len(q_lens)):                # S = 1 == the chunk kernel
        a, b = int(st[s]), int(en[s])
        one = torch.zeros(T, *q.shape[1:], dtype=q.dtype, device="cuda")
        one[:b - a] = q[a:b]
        o_c = tpa.paged_prefill_attention(
            one[None], k2, v2, bt[s:s + 1], ctx[s:s + 1],
            (en - st)[s:s + 1].contiguous(), **kw)
        assert torch.equal(o_c[0, :b - a], o_w[a:b])

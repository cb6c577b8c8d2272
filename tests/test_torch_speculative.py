"""The port's speculative decoding (``runners.SpeculativeRunner``,
``sampling.speculative_verify{,_full}``, ``BlockManager.truncate`` and
the scheduler's lookahead) on the CPU at glm4_9b's smoke size.

Greedy speculation emits the target's argmaxes, so its tokens equal plain
greedy decoding's, with a self-draft sharing the target's weights (which
accepts nearly every proposal: mean_accept_len > 1) and with a fresh
draft (which rejects nearly every one: the residual and rollback paths).
The verify pass's GEMMs take k + 1 rows a sequence where decode takes
one, and the CPU rounds a GEMM row by its position, so the comparison
uses the near-tie rule of ``test_torch_engine.py``; the JAX engine's
greedy speculation is held the same way. Also: k = 0 is the plain
engine; int8 pools; prefix hits with a boundary copy-on-write;
temperature speculation replays across preemption (the recompute stops
one token short); ``truncate`` frees the lookahead tail with ``free``'s
semantics, and after every step each decoding request holds exactly the
blocks of its context; the scheduler's budget and horizons."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jax_get_config
from repro.models import api as japi
from repro.serving import InferenceEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.config import get_config
from repro_torch.models import transformer
from repro_torch.models.api import params_from_jax
from repro_torch.serving import InferenceEngine, Request, SamplingParams
from repro_torch.serving.kv_cache import BlockManager, init_paged_cache
from repro_torch.serving.scheduler import Scheduler
import torch_cpu  # noqa: F401  (one torch thread)

BF16_TOL = 1e-2
K = 2
ENGINE = dict(max_batch=2, block_size=8, max_len=96,
              max_num_batched_tokens=2 * (1 + K) + 12)


@pytest.fixture(scope="module")
def setup():
    cfg = jax_get_config("glm4_9b", smoke=True)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    trees = []
    for seed in (0, 1):                        # target, fresh draft
        with jax.set_mesh(mesh):
            pf, _ = japi.init_model(cfg, jax.random.key(seed))
            trees.append(jax.tree.map(
                lambda x: np.asarray(x.astype(jnp.bfloat16)), pf))
    tcfg = get_config("glm4_9b", smoke=True)
    params = [params_from_jax(t, tcfg, "cpu") for t in trees]
    rng = np.random.default_rng(4)
    prefix = rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 9)
                               .astype(np.int32)]),
               prefix.copy(),                 # two full cached blocks: COW
               rng.integers(0, cfg.vocab_size, 30).astype(np.int32)]
    return cfg, mesh, trees, tcfg, params, prompts


def _run(setup, prompts=None, sampling=None, max_new=16, arrivals=None,
         draft=None, k=K, **kw):
    """A port engine run; ``draft`` "self" (shared weights) or "fresh"
    (the seed-1 parameters) makes it speculative with k tokens."""
    _, _, _, tcfg, params, default = setup
    prompts = default if prompts is None else prompts
    spec = {}
    if draft is not None:
        spec = dict(draft_cfg=tcfg, num_speculative_tokens=k,
                    draft_params=params[0] if draft == "self" else params[1])
    eng = InferenceEngine(tcfg, device="cpu", params=params[0],
                          debug_invariants=True, **{**ENGINE, **spec, **kw})
    reqs = [Request(p.copy(), max_new=max_new, rid=300 + i,
                    sampling=sampling or SamplingParams())
            for i, p in enumerate(prompts)]
    outs = eng.run(reqs, arrival_steps=arrivals)
    return eng, [outs[r.rid].tolist() for r in reqs]


def _last_logits(params, cfg, tokens):
    n, bs = len(tokens), 16
    nb = -(-n // bs)
    cache = init_paged_cache(cfg, nb + 1, bs, "cpu")

    def i32(x):
        return torch.tensor(x, dtype=torch.int32)

    batch = {"tokens": i32([list(tokens)]), "q_start": i32([0]),
             "q_lens": i32([n]), "block_tables": i32([list(range(1, nb + 1))]),
             "ctx_lens": i32([n])}
    with torch.no_grad():
        lg, _ = transformer.prefill_chunk_paged(params, cache, batch, cfg)
    return lg[0, :cfg.vocab_size]


def _same_or_near_tie(setup, prompt, ours, ref):
    """Equal greedy streams, or a first difference at a near-tie."""
    if ours == ref:
        return True
    _, _, _, tcfg, params, _ = setup
    i = next(j for j, (a, b) in enumerate(zip(ours, ref)) if a != b)
    lg = _last_logits(params[0], tcfg,
                      np.concatenate([prompt, np.asarray(ours[:i])]))
    top2 = torch.topk(lg, 2)
    margin = float(top2.values[0] - top2.values[1])
    assert set(top2.indices.tolist()) == {ours[i], ref[i]}, (i, top2)
    assert margin < BF16_TOL, f"step {i}: margin {margin:.4g}"
    return False


@pytest.mark.parametrize("draft", ["self", "fresh"])
def test_greedy_speculation_equals_plain_greedy(setup, draft):
    """Prefix hits, a boundary COW and staggered arrivals; greedy tokens
    equal the plain engine's (near-tie rule). A self-draft sharing the
    weights (and one fp32 head) accepts: mean_accept_len > 1; a fresh
    draft mostly rejects, so the residual token and the rollback run."""
    prompts = setup[5]
    arrivals = [0, 4, 6]
    plain_eng, plain = _run(setup, arrivals=arrivals)
    eng, spec = _run(setup, arrivals=arrivals, draft=draft)
    bitwise = all(_same_or_near_tie(setup, p, o, r)
                  for p, o, r in zip(prompts, spec, plain))
    s = eng.stats
    assert s["spec_decodes"] > 0 and s["cache_hit_tokens"] > 0
    assert s["cow_copies"] >= 1
    if draft == "self":
        assert eng.runner.draft_head is eng.runner.head
        assert eng.mean_accept_len > 1.5
    else:
        assert eng.runner.draft_head is not eng.runner.head
        assert 1.0 <= eng.mean_accept_len < 1.5
    # every token but each request's first (its prefill chunk's) came out
    # of a verify step
    assert s["tokens"] == s["spec_emitted"] + len(prompts)
    assert all(len(o) == 16 for o in spec)
    if draft == "self" and bitwise:
        assert s["steps"] < plain_eng.stats["steps"]


def test_greedy_speculation_matches_the_reference_engine(setup):
    """The JAX engine's greedy speculation with the same target and draft
    weights: the same tokens, near-tie rule."""
    cfg, mesh, trees, _, _, prompts = setup
    jeng = JaxEngine(cfg, mesh, params=jax.tree.map(jnp.asarray, trees[0]),
                     draft_cfg=cfg, num_speculative_tokens=K,
                     draft_params=jax.tree.map(jnp.asarray, trees[1]),
                     **ENGINE)
    jreqs = [JaxRequest(p.copy(), max_new=16, rid=300 + i)
             for i, p in enumerate(prompts)]
    jouts = jeng.run(jreqs)
    eng, spec = _run(setup, draft="fresh")
    for p, ours, jr in zip(prompts, spec, jreqs):
        _same_or_near_tie(setup, p, ours, jouts[jr.rid].tolist())
    assert eng.stats["spec_decodes"] > 0


def test_k0_equals_plain(setup):
    """A draft with k = 0: the verify step is sample_tokens on one row,
    so greedy and temperature runs equal the plain engine's."""
    for sp in (None, SamplingParams(temperature=0.9, top_k=30, seed=3)):
        _, plain = _run(setup, sampling=sp)
        eng, spec = _run(setup, sampling=sp, draft="fresh", k=0,
                         max_num_batched_tokens=2 + 12)
        assert eng.runner.spec_tokens == 0 and eng.stats["spec_decodes"] > 0
        assert eng.mean_accept_len == 1.0
        for p, o, r in zip(setup[5], spec, plain):
            if sp is None:
                _same_or_near_tie(setup, p, o, r)
            else:
                assert o == r


def test_speculation_over_int8_pools(setup):
    """Both pool sets int8 (per-row scales beside each): greedy
    speculation equals plain greedy over int8 pools."""
    _, plain = _run(setup, kv_dtype="int8")
    eng, spec = _run(setup, kv_dtype="int8", draft="self")
    assert eng.cache["tgt"]["k"].dtype == eng.cache["dft"]["k"].dtype \
        == torch.int8 and "k_scale" in eng.cache["dft"]
    for p, o, r in zip(setup[5], spec, plain):
        _same_or_near_tie(setup, p, o, r)


@pytest.mark.parametrize("sampling", [
    SamplingParams(temperature=0.8, top_k=40, seed=7),
    SamplingParams(temperature=0.9, top_p=0.9, repetition_penalty=1.2,
                   logprobs=2, seed=8)], ids=["plain", "full"])
def test_temperature_speculation_replays_across_preemption(setup, sampling):
    """A pool too small for both requests' lookahead preempts one; the
    recompute stops one token short and the verify step emits it again,
    so the streams equal an uninterrupted run's."""
    prompts = setup[5][2:] + setup[5][:1]
    eng, tight = _run(setup, prompts, sampling, max_new=24, draft="fresh",
                      num_blocks=10)
    assert eng.stats["preemptions"] >= 1
    _, free = _run(setup, prompts, sampling, max_new=24, draft="fresh")
    assert tight == free


def test_blocks_rolled_back_after_every_step(setup):
    """After every step each request that decoded and still runs holds
    exactly the blocks of its context: the verify's lookahead tail went
    back to the pool."""
    checked, decoded = [], []
    _, _, _, tcfg, params, prompts = setup
    eng = InferenceEngine(tcfg, device="cpu", params=params[0],
                          draft_cfg=tcfg, draft_params=params[1],
                          num_speculative_tokens=K, debug_invariants=True,
                          **ENGINE)
    step, schedule = eng.step, eng.sched.schedule

    def recorded_schedule():
        plan = schedule()
        decoded[:] = [r for _, r in plan.decodes]
        return plan

    def checked_step():
        out = step()
        for req in decoded:
            if any(r is req for r in eng.sched.running.values()):
                assert len(eng.bm.table(req.rid)) == \
                    eng.bm.blocks_for(req.context_len)
                checked.append(req.rid)
        eng.bm.check()
        return out

    eng.sched.schedule, eng.step = recorded_schedule, checked_step
    eng.run([Request(p.copy(), max_new=20, rid=400 + i)
             for i, p in enumerate(prompts)])
    assert len(checked) > 10


def test_truncate_frees_the_tail():
    """truncate keeps blocks_for(n) blocks; dropped blocks lose one
    reference, go to the free list at zero and keep their hash."""
    bm = BlockManager(12, 4)
    t = bm.allocate(1, 14)                         # 4 blocks
    bm.register(t[3], b"h3")
    bm.adopt(2, t[:2])                             # shared prefix
    free0 = bm.num_free
    dropped = bm.truncate(1, 5)                    # keep 2 blocks
    assert dropped == [t[3], t[2]] and bm.table(1) == t[:2]
    assert bm.num_free == free0 + 2 and bm.match([b"h3"]) == [t[3]]
    assert bm.truncate(2, 1) == [t[1]]             # shared: ref only
    assert bm.refcount(t[1]) == 1 and bm.num_free == free0 + 2
    assert bm.truncate(1, 8) == [] and bm.truncate(1, 0) == t[:2][::-1]
    bm.check()


def test_scheduler_lookahead():
    """Each decode costs 1 + k budget tokens and ensures context_len + 1
    + k; the budget must exceed max_batch x (1 + k)."""
    with pytest.raises(ValueError, match="spec_tokens"):
        Scheduler(BlockManager(20, 4), 2, 8, 2 * 3, 6, spec_tokens=2)
    bm = BlockManager(20, 4)
    s = Scheduler(bm, 2, 8, 2 * 3 + 6, 6, spec_tokens=2)
    req = Request(np.arange(5, dtype=np.int32), max_new=8)
    s.add(req)
    plan = s.schedule()
    assert plan.chunks == [(0, req, 5)] and plan.spec_tokens == 2
    req.num_computed = 5
    req.out.append(1)
    plan = s.schedule()
    assert plan.decodes == [(0, req)] and plan.scheduled_tokens == 3
    assert len(bm.table(req.rid)) == bm.blocks_for(6 + 1 + 2)

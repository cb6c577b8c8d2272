"""The host swap tier and ``abort`` in the port, on the CPU at smoke size.

Against the JAX package, on the same inputs: one random tape drives both
``BlockManager``s through the host tier (swap out / in / discard, host
prefix hits) with identical tables, pairs and free lists after every
operation; ``SwapCostModel`` makes the same decisions; both
``Scheduler``s plan the same swap preemptions, swap-ins and aborts; and
the port's engine with ``swap_policy="always"`` gives the JAX engine's
greedy tokens (up to a near-tie, as in ``test_torch_engine.py``) and its
swap counters.

Inside the port, the reference's invariants: swap == recompute ==
uninterrupted byte for byte over bf16, int8 and fp8 pools and with
speculative k = 2; an abort frees everything its request held, and a
request admitted into an aborted request's slot inherits nothing from it
(penalty counts, draft pages, SSM slot state)."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.config import get_config as jax_get_config
from repro.models import api as japi
from repro.serving import InferenceEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving.kv_cache import BlockManager as JBM
from repro.serving.kv_cache import block_bytes as jax_block_bytes
from repro.serving.scheduler import Request as JReq
from repro.serving.scheduler import Scheduler as JSched
from repro.serving.scheduler import SwapCostModel as JCost
from repro_torch.config import get_config
from repro_torch.models.api import params_from_jax
from repro_torch.serving import InferenceEngine, Request, SamplingParams
from repro_torch.serving.kv_cache import BlockManager, block_bytes
from repro_torch.serving.scheduler import Scheduler, SwapCostModel

from test_torch_engine import _assert_same_or_near_tie
import torch_cpu  # noqa: F401  (one torch thread)


def _state(bm):
    return (bm._tables, bm._ref, bm._free, bm._hash_of, bm._block_of,
            bm._host_free, bm._swapped, bm._host_hash_of,
            bm._host_block_of)


def _host_tier_walk(rng, n_ops=160):
    """allocate / grow / free / register / adopt / truncate / swap out /
    swap in / swap discard / host prefix hit, on both managers in lock
    step: equal results (or equal exceptions) and equal state after every
    operation, both tiers' invariants checked."""
    NB, BS, NH = 9, 4, 6
    a = JBM(num_blocks=NB, block_size=BS, num_host_blocks=NH)
    b = BlockManager(NB, BS, num_host_blocks=NH)
    live, swapped, hashes = [], [], []
    next_rid = [0]

    def both(fn):
        out = []
        for bm in (a, b):
            try:
                out.append(("ok", fn(bm)))
            except (MemoryError, KeyError) as e:
                out.append(("err", type(e)))
        assert out[0] == out[1], out
        return out[0]

    def new_rid():
        next_rid[0] += 1
        return next_rid[0]

    for _ in range(n_ops):
        op = rng.randrange(10)
        if op == 0 or not (live or swapped):             # allocate
            rid = new_rid()
            n = rng.randrange(3 * BS + 1)
            if both(lambda bm: bm.allocate(rid, n))[0] == "ok":
                live.append(rid)
        elif op == 1 and live:                           # grow
            rid = rng.choice(live)
            want = len(b.table(rid)) * BS + rng.randrange(2 * BS) + 1
            both(lambda bm: bm.ensure(rid, want))
        elif op == 2 and live:                           # free
            rid = live.pop(rng.randrange(len(live)))
            both(lambda bm: bm.free(rid))
        elif op == 3 and live:                           # register
            t = b.table(rng.choice(live))
            if t:
                h = b"h%d" % rng.randrange(12)
                blk = rng.choice(t)
                both(lambda bm: bm.register(blk, h))
                hashes.append(h)
        elif op == 4 and hashes:                         # adopt a match
            h = rng.choice(hashes)
            blocks = both(lambda bm: bm.match([h]))[1]
            if blocks:
                rid = new_rid()
                both(lambda bm: bm.adopt(rid, blocks))
                live.append(rid)
        elif op == 5 and live:                           # truncate
            rid = rng.choice(live)
            n = rng.randrange(len(b.table(rid)) * BS + 1)
            both(lambda bm: bm.truncate(rid, n))
        elif op == 6 and live:                           # swap out
            rid = rng.choice(live)
            if both(lambda bm: bm.can_swap_out(rid))[1]:
                both(lambda bm: bm.swap_out(rid))
                live.remove(rid)
                swapped.append(rid)
        elif op == 7 and swapped:                        # swap in
            rid = rng.choice(swapped)
            if both(lambda bm: bm.can_swap_in(rid))[1]:
                both(lambda bm: bm.swap_in(rid))
                swapped.remove(rid)
                live.append(rid)
        elif op == 8 and swapped:                        # swap discard
            rid = swapped.pop(rng.randrange(len(swapped)))
            both(lambda bm: bm.swap_discard(rid))
        elif op == 9 and hashes:                         # host prefix hit
            hs = [rng.choice(hashes) for _ in range(rng.randrange(1, 3))]
            slots = both(lambda bm: bm.match_host(hs))[1]
            if slots and len(slots) <= b.num_free:
                rid = new_rid()
                both(lambda bm: bm.host_copy_in(rid, slots,
                                                hs[:len(slots)]))
                live.append(rid)
        assert _state(a) == _state(b)
        assert (a.num_host_free, a.num_free) == (b.num_host_free, b.num_free)
        b.check()
    for rid in live:
        both(lambda bm: bm.free(rid))
    for rid in swapped:
        both(lambda bm: bm.swap_discard(rid))
    assert _state(a) == _state(b)
    assert (b.num_free, b.num_host_free) == (NB - 1, NH)
    b.check()


@pytest.mark.parametrize("seed", range(8))
def test_host_tier_matches_reference_random_walk(seed):
    _host_tier_walk(random.Random(seed))


def test_host_tier_reference_cases():
    """The reference's host-tier unit cases, each run on both managers:
    a swap round trip revives the free device twins with no copy; after
    the twins are recycled, swap-in copies and re-registers; a host prefix
    hit copies in and the owner's later swap-in shares its blocks; a
    discard frees the slots and their host hashes."""
    outs = []
    for BM in (JBM, BlockManager):
        bm = BM(num_blocks=6, block_size=4, num_host_blocks=4)
        log = []
        bm.allocate(1, 8)
        t0 = bm.table(1)
        bm.register(t0[0], b"h0"), bm.register(t0[1], b"h1")
        log.append(bm.swap_out(1))
        log.append(bm.match_host([b"h0", b"h1"]))
        log.append(bm.swap_in(1))                     # pure revival
        log.append(bm.swap_out(1))
        bm.allocate(2, 20)                            # recycle every block
        log.append((bm.match([b"h0", b"h1"]), bm.can_swap_in(1)))
        slots = bm.match_host([b"h0", b"h1"])
        bm.free(2)
        log.append(bm.host_copy_in(3, slots, [b"h0", b"h1"]))
        log.append(bm.swap_in(1))                     # shares rid 3's
        log.append([bm.refcount(x) for x in bm.table(1)])
        bm.free(1), bm.free(3)
        bm.allocate(4, 8)
        bm.register(bm.table(4)[0], b"h9")
        bm.swap_out(4)
        bm.swap_discard(4)
        log.append((bm.num_host_free, bm.match_host([b"h9"]), bm.num_free))
        bm.check()
        outs.append(log)
    assert outs[0] == outs[1]
    assert outs[1][2][1] == [] and outs[1][6][1] == []  # revivals: no copy


def test_swap_cost_model_matches_reference():
    """Same defaults, same decisions over a grid of victims, the same EMA
    moves after the same observations, for every policy."""
    rng = random.Random(0)
    for policy in ("auto", "always", "never"):
        ours, ref = (SwapCostModel(block_bytes=1 << 20, policy=policy),
                     JCost(block_bytes=1 << 20, policy=policy))
        for _ in range(50):
            nb, nt = rng.randrange(0, 128), rng.randrange(0, 4096)
            assert ours.prefer_swap(nb, nt) == ref.prefer_swap(nb, nt)
            nbytes, secs = rng.randrange(1 << 31), rng.random()
            ntok = rng.randrange(1 << 17)
            for m in (ours, ref):
                m.observe_swap(nbytes, secs)
                m.observe_prefill(ntok, secs)
            assert (ours.bytes_per_s, ours.prefill_tok_s) == \
                (ref.bytes_per_s, ref.prefill_tok_s)
    m = SwapCostModel(block_bytes=1 << 20)
    assert m.prefer_swap(2, 100) and not m.prefer_swap(64, 4)


def _plan_key(plan):
    return ([(s, r.rid) for s, r in plan.decodes],
            [(s, r.rid, n) for s, r, n in plan.chunks],
            list(plan.copies), plan.admitted, list(plan.swap_outs),
            list(plan.swap_ins), list(plan.shared_ins))


def _drive(s, plan, step, done):
    """The engine's bookkeeping for one plan with a fake model: token =
    a step-dependent constant."""
    for slot, r in plan.decodes:
        r.num_computed += 1
        r.out.append((step * 7 + r.rid) % 50)
        s.note_progress(r)
        if r.done:
            done.append(r.rid)
            s.retire(slot)
    for slot, r, n in plan.chunks:
        r.num_computed += n
        if r.num_computed == r.context_len:
            r.out.append((step * 7 + r.rid) % 50)
            s.note_progress(r)
            if r.done:
                done.append(r.rid)
                s.retire(slot)
        else:
            s.note_progress(r)


@pytest.mark.parametrize("policy,prefix,abort", [
    ("always", True, True), ("always", True, False),
    ("always", False, False), ("never", True, True)])
def test_scheduler_swap_and_abort_plans_match_reference(policy, prefix,
                                                        abort):
    """A tight pool with a host tier: the same plans (swap-outs, swap-ins,
    host prefix hits), counters and outputs step by step; aborts of a
    swapped, a waiting and a running request land on the same steps."""
    rng = np.random.default_rng(3)
    base = rng.integers(0, 50, 12).astype(np.int32)
    prompts = [base.copy(), np.concatenate([base, [1, 2, 3]]).astype(
        np.int32)] + [rng.integers(0, 50, 10).astype(np.int32)
                      for _ in range(3)]
    arrivals = [0, 0, 2, 4, 4]

    def victims(s, bm):
        """step -> the rid to abort: a swapped request (if any), a waiting
        one, the oldest running one"""
        waiting = [r.rid for r in s.waiting]
        return {6: next((r for r in waiting if bm.is_swapped(r)), None),
                7: next((r for r in waiting if not bm.is_swapped(r)), None),
                11: min((r.rid for r in s.running.values()), default=None)}
    runs = []
    for BM, Sched, Req, Cost in ((JBM, JSched, JReq, JCost),
                                 (BlockManager, Scheduler, Request,
                                  SwapCostModel)):
        bm = BM(9, 4, num_host_blocks=10)
        s = Sched(bm, 3, 8, 3 + 6, 6, enable_prefix_caching=prefix,
                  swap_cost=Cost(block_bytes=64, policy=policy))
        reqs = [Req(p.copy(), max_new=8, rid=1000 + i)
                for i, p in enumerate(prompts)]
        plans, done, aborted, step = [], [], [], 0
        pending = list(zip(arrivals, reqs))
        while pending or s.has_work:
            while pending and pending[0][0] <= step:
                s.add(pending.pop(0)[1])
            rid = victims(s, bm).get(step) if abort else None
            if rid is not None:
                aborted.append((step, rid, bm.is_swapped(rid), s.abort(rid)))
            plan = s.schedule()
            plans.append(_plan_key(plan))
            _drive(s, plan, step, done)
            bm.check()
            step += 1
            assert step < 500
        assert not s.abort(1000)                  # retired: a no-op
        runs.append((plans, done, aborted, s.n_preemptions,
                     s.n_swap_preemptions, s.n_swap_ins, s.n_aborts,
                     s.host_hit_blocks, s.cache_hit_tokens,
                     [r.out for r in reqs], bm.num_free, bm.num_host_free))
    assert runs[0] == runs[1]
    plans, _, aborted, n_pre, n_swap = runs[1][:5]
    assert n_pre > 0 and all(ok for *_, ok in aborted)
    assert runs[1][6] == len(aborted) and (len(aborted) >= 2) == abort
    if policy == "never":
        assert n_swap == 0
    elif abort:
        assert any(swapped for _, _, swapped, _ in aborted)
    else:
        assert n_swap > 0 and any(p[4] for p in plans)
        assert runs[1][5] > 0 and any(p[5] for p in plans)  # swapped in
    assert runs[1][10:] == (8, 10)                # everything released


def test_scheduler_swap_preemption_keeps_progress():
    """The reference's choreography: a's growth swaps b out with its
    progress; after a retires, b swaps back in and decodes with no
    recompute chunk; aborting a swapped request frees its host slots."""
    for abort in (False, True):
        bm = BlockManager(7, 2, num_host_blocks=8)
        s = Scheduler(bm, 2, 6, 8, 4, enable_prefix_caching=False,
                      swap_cost=SwapCostModel(block_bytes=64,
                                              policy="always"))
        a, b = (Request(np.arange(4, dtype=np.int32), max_new=4)
                for _ in range(2))
        s.add(a), s.add(b)
        for _ in range(2):
            _, r, n = s.schedule().chunk
            r.num_computed += n
            r.out.append(7)
        s.schedule()
        for r in (a, b):
            r.out.append(8)
            r.num_computed += 1
        plan = s.schedule()
        assert s.n_swap_preemptions == 1 and len(plan.swap_outs) == 3
        assert bm.is_swapped(b.rid) and s.waiting[0] is b
        assert b.num_computed == 5 and b.out == [7, 8]
        if abort:
            assert s.abort(b.rid) and s.n_aborts == 1
            assert bm.num_host_free == 8 and not s.waiting
            bm.check()
            continue
        s.retire(next(sl for sl, r in s.running.items() if r is a))
        plan2 = s.schedule()
        assert s.n_swap_ins == 1 and len(plan2.swap_ins) == 3
        assert plan2.chunk is None and b.num_computed == 5
        assert [r.rid for _, r in s.schedule().decodes] == [b.rid]
        bm.check()


def test_scheduler_drain_and_on_admit():
    bm = BlockManager(17, 4)
    s = Scheduler(bm, 2, 4, 12, 8)
    seen = []
    s.on_admit = lambda slot, req: seen.append((slot, req.rid))
    a = Request(np.arange(8, dtype=np.int32), max_new=2)
    s.add(a)
    s.schedule()
    assert seen == [(0, a.rid)]
    s.drain()
    s.drain()                                     # idempotent
    with pytest.raises(RuntimeError, match="draining"):
        s.add(Request(np.arange(8, dtype=np.int32), max_new=2))
    assert s.has_work and s.draining


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    cfg = jax_get_config("glm4_9b", smoke=True)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    with jax.set_mesh(mesh):
        pf, _ = japi.init_model(cfg, jax.random.key(0))
        tree = jax.tree.map(lambda x: np.asarray(x.astype(jnp.bfloat16)), pf)
    tcfg = get_config("glm4_9b", smoke=True)
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, cfg.vocab_size, 32).astype(np.int32)
               for _ in range(3)]
    return cfg, mesh, tree, tcfg, params_from_jax(tree, tcfg, "cpu"), prompts


TIGHT = dict(max_batch=2, block_size=16, max_len=96, num_blocks=8)
SWAP_KEYS = ("swap_preemptions", "swap_ins", "preemptions",
             "swapped_out_blocks", "swapped_in_blocks", "swapped_out_bytes",
             "swapped_in_bytes", "host_hit_blocks", "swap_space_mib")


def _run(eng, prompts, max_new=20, rid0=None, **rkw):
    """Serve ``prompts``; sampled requests need fixed rids (their streams
    are keyed by rid): ``rid0``, ``rid0 + 1``, ..."""
    reqs = [Request(p.copy(), max_new=max_new, **rkw) if rid0 is None else
            Request(p.copy(), max_new=max_new, rid=rid0 + i, **rkw)
            for i, p in enumerate(prompts)]
    outs = eng.run(reqs)
    return [outs[r.rid].tolist() for r in reqs]


def test_engine_swap_matches_reference(setup):
    """swap_policy="always" under block pressure in both packages: the
    same swap counters, greedy tokens equal up to a near-tie."""
    cfg, mesh, tree, tcfg, params, prompts = setup
    bb = jax_block_bytes(cfg, 16)
    assert bb == block_bytes(tcfg, 16)
    jeng = JaxEngine(cfg, mesh, params=jax.tree.map(jnp.asarray, tree),
                     swap_space_bytes=8 * bb, swap_policy="always",
                     debug_invariants=True, **TIGHT)
    jreqs = [JaxRequest(p.copy(), max_new=20) for p in prompts]
    jouts = jeng.run(jreqs)
    eng = InferenceEngine(tcfg, device="cpu", params=params,
                          swap_space_bytes=8 * bb, swap_policy="always",
                          debug_invariants=True, **TIGHT)
    outs = _run(eng, prompts)
    assert eng.stats["swap_preemptions"] >= 1
    for key in SWAP_KEYS:
        assert eng.stats[key] == jeng.stats[key], key
    for p, ours, jr in zip(prompts, outs, jreqs):
        _assert_same_or_near_tie(eng, p, ours, jouts[jr.rid].tolist())
    assert eng.bm.stats().blocks_in_use == 0
    assert eng.bm.num_host_free == eng.bm.num_host_blocks == 8


@pytest.mark.parametrize("kv", ["bf16", "int8", "fp8"])
def test_swap_equals_recompute_equals_uninterrupted(setup, kv):
    """Byte identity across the three ways to serve the same requests; the
    swap run moves whole blocks (scales included) and frees every block
    and host slot."""
    tcfg, params, prompts = setup[3], setup[4], setup[5]
    kw = dict(device="cpu", params=params, kv_dtype=kv,
              debug_invariants=True)
    free = _run(InferenceEngine(tcfg, max_batch=2, block_size=16,
                                max_len=96, **kw), prompts)
    bb = block_bytes(tcfg, 16, kv_dtype=kv)
    outs, engs = {}, {}
    for policy in ("always", "never"):
        engs[policy] = eng = InferenceEngine(
            tcfg, swap_space_bytes=8 * bb, swap_policy=policy, **TIGHT, **kw)
        outs[policy] = _run(eng, prompts)
    assert outs["always"] == outs["never"] == free
    s = engs["always"].stats
    assert s["swap_preemptions"] >= 1 and s["swap_ins"] >= 1
    assert s["swapped_out_bytes"] == s["swapped_out_blocks"] * bb
    assert s["swap_space_mib"] == round(8 * bb / 2 ** 20, 3)
    assert engs["never"].stats["swap_preemptions"] == 0
    assert engs["never"].stats["preemptions"] >= 1
    for eng in engs.values():
        assert eng.bm.stats().blocks_in_use == 0
        assert eng.bm.num_host_free == eng.bm.num_host_blocks


def test_swap_speculative_and_full_sampling(setup):
    """Speculative k = 2 (a self-draft: both pool sets swap under one
    block id) and a full-sampling request under swap and under recompute
    preemption: byte identical to the uncontended engine."""
    tcfg, params, prompts = setup[3], setup[4], setup[5]
    sp = SamplingParams(temperature=0.9, top_p=0.9, repetition_penalty=1.2,
                        logprobs=2, seed=5)
    spec = dict(num_speculative_tokens=2, draft_params=params)
    for extra, rkw in ((spec, {}), ({}, {"sampling": sp, "rid0": 700})):
        kw = dict(device="cpu", params=params, debug_invariants=True,
                  **extra)
        base = InferenceEngine(tcfg, max_batch=2, block_size=16,
                               max_len=96, **kw)
        want = _run(base, prompts[:2], **rkw)
        bb = base._dev_block_bytes
        assert bb == block_bytes(tcfg, 16) * (2 if extra else 1)
        for policy in ("always", "never"):
            eng = InferenceEngine(tcfg, swap_space_bytes=16 * bb,
                                  swap_policy=policy, **TIGHT, **kw)
            assert eng.bm.num_host_blocks == 16
            assert _run(eng, prompts[:2], **rkw) == want
            assert eng.stats["preemptions"] >= 1
            assert (eng.stats["swap_preemptions"] >= 1) == \
                (policy == "always")


def test_engine_abort_mid_run_releases_everything(setup):
    """A running, a waiting and a swapped request aborted between steps:
    counted, their blocks and host slots freed, the survivor untouched."""
    tcfg, params, prompts = setup[3], setup[4], setup[5]
    want = _run(InferenceEngine(tcfg, device="cpu", params=params,
                                max_batch=2, block_size=16, max_len=96),
                prompts[1:2], max_new=24)[0]
    bb = block_bytes(tcfg, 16)
    eng = InferenceEngine(tcfg, device="cpu", params=params,
                          swap_space_bytes=8 * bb, swap_policy="always",
                          debug_invariants=True, **TIGHT)
    reqs = [Request(p.copy(), max_new=24) for p in prompts]
    for r in reqs:
        eng.sched.add(r)
    for _ in range(6):
        eng.step()
    assert eng.abort(reqs[0].rid)                  # running
    assert eng.abort(reqs[2].rid)                  # waiting
    assert not eng.abort(reqs[0].rid)              # already gone
    while eng.sched.has_work:
        eng.step()
    assert eng.stats["aborts"] == 2
    assert reqs[1].out == want
    assert 0 < len(reqs[0].out) < 24 and len(reqs[2].out) <= 1
    # a swapped victim aborted: its host slots come back (three slots, so
    # the victim cannot swap straight back in within its own plan)
    eng2 = InferenceEngine(tcfg, device="cpu", params=params,
                           swap_space_bytes=8 * bb, swap_policy="always",
                           debug_invariants=True, **dict(TIGHT, max_batch=3))
    reqs = [Request(p.copy(), max_new=20) for p in prompts]
    for r in reqs:
        eng2.sched.add(r)
    for _ in range(100):
        eng2.step()
        victim = next((r for r in reqs if eng2.bm.is_swapped(r.rid)), None)
        if victim is not None:
            break
    assert victim is not None, "no request stayed swapped between steps"
    assert eng2.bm.num_host_free < 8 and eng2.abort(victim.rid)
    while eng2.sched.has_work:
        eng2.step()
    for eng in (eng, eng2):
        assert eng.bm.stats().blocks_in_use == 0
        assert eng.bm.num_host_free == eng.bm.num_host_blocks
        eng.bm.check()


@pytest.mark.parametrize("arch,extra", [
    ("glm4_9b", {}), ("glm4_9b", {"num_speculative_tokens": 2}),
    ("mamba2_370m", {})])
def test_slot_reuse_after_abort(setup, arch, extra):
    """A penalised request aborted mid-run leaves nothing behind: the
    request admitted into its slot (its penalty count rows, its draft
    pages, its SSM slot state) gives the tokens it gives alone."""
    cfg = get_config(arch, smoke=True)
    params = setup[4] if arch == "glm4_9b" else None
    if extra:
        extra = dict(extra, draft_params=params)
    rng = np.random.default_rng(5)
    victim, heir = (rng.integers(0, cfg.vocab_size, 24).astype(np.int32)
                    for _ in range(2))
    sp = SamplingParams(repetition_penalty=1.5, frequency_penalty=0.5,
                        presence_penalty=0.5)
    kw = dict(device="cpu", params=params, max_batch=1, block_size=16,
              max_len=96, debug_invariants=True, seed=0, **extra)
    alone = InferenceEngine(cfg, **kw)
    want = _run(alone, [heir], max_new=8, rid0=801, sampling=sp)[0]
    eng = InferenceEngine(cfg, **kw)
    first = Request(victim.copy(), max_new=30, sampling=sp, rid=800)
    second = Request(heir.copy(), max_new=8, sampling=sp, rid=801)
    eng.sched.add(first)
    eng.sched.add(second)
    while len(first.out) < 5:
        eng.step()
    assert eng.abort(first.rid)
    while eng.sched.has_work:
        eng.step()
    assert second.out == want
    assert eng.stats["aborts"] == 1
    if eng.bm is not None:
        assert eng.bm.stats().blocks_in_use == 0

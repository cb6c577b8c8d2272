"""The port's data-parallel router and shared prefix index on the CPU at
smoke size.

Against the JAX package, on the same inputs: ``SharedPrefixIndex``'s
publish / adopt cycle, racing publishers, LRU eviction with pins and the
layout check give the same slots, hashes and stats; a random walk over
two ``BlockManager``s and one shared index (publish, adopt, release,
retire, truncate, swap) keeps every table, free list and slot map equal
to the reference's.

Inside the port, the reference's contract (tests/test_router.py): routed
over dp in {1, 2, 3} replicas, every request's tokens equal one engine's,
byte for byte (duplicate prompts, temperature and full-sampling rows,
staggered arrivals); a prompt served on one replica is adopted on the
other through the shared index; preemption on one replica; speculative
k = 2 replicas; the disaggregated prefill -> decode handoff, with stop
sequences and min_new across it; the router's refusals."""

import random

import numpy as np
import pytest

from repro.serving.kv_cache import BlockManager as JBM
from repro.serving.kv_cache import SharedPrefixIndex as JIndex
from repro_torch.config import get_config
from repro_torch.models.api import init_model
from repro_torch.serving import (InferenceEngine, ReplicaRouter, Request,
                                 SamplingParams, SharedPrefixIndex)
from repro_torch.serving.kv_cache import BlockManager

RNG = np.random.default_rng(11)


def _chain(tag: bytes, n: int) -> list[bytes]:
    return [tag + bytes([i]) for i in range(n)]


def _index_state(idx):
    return (idx._free, idx._slot_of, idx._hash_of, idx._reserved,
            idx._pins, idx._order, idx.stats())


def _both(fn):
    """``fn(index_class)`` for the reference and the port: equal logs."""
    ref, ours = fn(JIndex), fn(SharedPrefixIndex)
    assert ref == ours
    return ours


def test_shared_index_cases_match_reference():
    def publish_adopt(Index):
        idx, log = Index(num_slots=4), []
        hs = _chain(b"a", 3)
        for h in hs:
            s = idx.reserve(h)
            log.append((s, idx.contains(h)))           # invisible: reserved
            idx.commit(s, h)
            log.append(idx.contains(h))
        log.append(idx.reserve(hs[0]))                 # committed: None
        pairs = idx.acquire(hs + [b"missing"])         # longest prefix
        log += [pairs, idx.stats()]
        s4 = idx.reserve(b"x1")
        log += [s4, idx.reserve(b"x2")]                # all pinned: None
        idx.abandon(s4)
        idx.release([s for s, _ in pairs])
        idx.check()
        return log + [_index_state(idx)]

    def racing(Index):
        idx = Index(num_slots=4)
        s_a, s_b = idx.reserve(b"h"), idx.reserve(b"h")
        idx.commit(s_a, b"h")
        idx.commit(s_b, b"h")                          # loser's slot frees
        log = [s_a, s_b, idx.stats(), idx.acquire([b"h"]), idx.reserve(b"x")]
        idx.check()
        return log + [_index_state(idx)]

    def lru(Index):
        idx = Index(num_slots=2)
        for h in (b"h1", b"h2"):
            idx.commit(idx.reserve(h), h)
        pinned = idx.acquire([b"h1"])
        s3 = idx.reserve(b"h3")                        # evicts h2, not h1
        idx.commit(s3, b"h3")
        log = [s3, idx.contains(b"h1"), idx.contains(b"h2"), idx.stats()]
        pinned += idx.acquire([b"h3"])
        log.append(idx.reserve(b"h4"))                 # all pinned: None
        idx.release([s for s, _ in pinned])
        log.append(idx.reserve(b"h4"))
        idx.check()
        return log + [_index_state(idx)]

    log = _both(publish_adopt)
    assert log[-1][-1]["published_blocks"] == 3 and log[10] is None
    log = _both(racing)
    assert log[2]["published_blocks"] == 1 and log[4] == log[1]
    log = _both(lru)
    assert log[3]["evicted_blocks"] == 1 and log[4] is None


def test_shared_index_pool_layout():
    """One host tensor per paged pool, ``(num_slots,) + shape``; a second
    replica must present the same layout; the reference refuses the same
    mismatch."""
    import torch
    idx = SharedPrefixIndex(num_slots=3)
    idx.attach_pool([((4, 8), torch.float32), ((4, 8), torch.uint8)])
    idx.attach_pool([((4, 8), torch.float32), ((4, 8), torch.uint8)])
    assert [tuple(p.shape) for p in idx.pool] == [(3, 4, 8)] * 2
    assert [p.dtype for p in idx.pool] == [torch.float32, torch.uint8]
    with pytest.raises(ValueError, match="layout mismatch"):
        idx.attach_pool([((4, 8), torch.float32)])
    for attach, dtype in ((SharedPrefixIndex(2).attach_pool, torch.float32),
                          (JIndex(2).attach_pool, np.float32)):
        attach([((4, 8), dtype)])
        with pytest.raises(ValueError, match="layout mismatch"):
            attach([((4, 9), dtype)])
    with pytest.raises(ValueError):
        SharedPrefixIndex(num_slots=0)


_WALK_CHAINS = [_chain(bytes([t]), 4) for t in range(6)]


def _two_manager_walk(seed):
    """One random publish / adopt / release / retire / truncate / swap
    interleaving over two BlockManagers and a shared index, applied to the
    reference's objects and the port's in lock step: equal results and
    equal state after every operation."""
    BS = 4
    rng = random.Random(seed)
    sides = []
    for Index, BM in ((JIndex, JBM), (SharedPrefixIndex, BlockManager)):
        shared = Index(num_slots=6)
        sides.append((shared, [BM(8, BS, num_host_blocks=3,
                                  shared_index=shared) for _ in range(2)]))
    live = [{}, {}]
    pins = []
    next_rid = [1000, 2000]

    def apply(fn):
        outs = [fn(shared, bms) for shared, bms in sides]
        assert outs[0] == outs[1], outs
        return outs[1]

    def state(shared, bms):
        return (_index_state(shared),
                [(bm._tables, bm._ref, bm._free, bm._hash_of,
                  bm._publish_q, bm._swapped, bm._host_free) for bm in bms])

    for _ in range(rng.randint(10, 30)):
        op = rng.choice(("alloc", "publish", "adopt", "release", "retire",
                         "truncate", "swap"))
        i = rng.randint(0, 1)
        bm = sides[1][1][i]
        if op == "alloc":
            chain, n = rng.choice(_WALK_CHAINS), rng.randint(1, 4)
            if bm.num_free >= n:
                rid = next_rid[i] = next_rid[i] + 1

                def alloc(shared, bms):
                    blocks = bms[i].allocate(rid, n * BS)
                    for b, h in zip(blocks, chain):
                        bms[i].register(b, h)
                    return blocks
                apply(alloc)
                live[i][rid] = n
        elif op == "publish":
            abandon = [rng.random() < 0.2 for _ in range(8)]

            def publish(shared, bms):
                out = []
                for k, (b, h) in enumerate(bms[i].drain_publishable()):
                    s = shared.reserve(h)
                    if s is not None:
                        (shared.abandon(s) if abandon[k % 8]
                         else shared.commit(s, h))
                    out.append((b, h, s))
                return out
            apply(publish)
        elif op == "adopt":
            chain = rng.choice(_WALK_CHAINS)
            rid = next_rid[i] + 1

            def adopt(shared, bms):
                pairs = shared.acquire(chain, limit=bms[i].num_free)
                if pairs:
                    bms[i].host_copy_in(rid, [s for s, _ in pairs],
                                        [h for _, h in pairs])
                return pairs
            pairs = apply(adopt)
            if pairs:
                next_rid[i] = rid
                live[i][rid] = len(pairs)
                pins.append([s for s, _ in pairs])
        elif op == "release" and pins:
            slots = pins.pop(rng.randrange(len(pins)))
            apply(lambda shared, bms: shared.release(slots))
        elif op in ("retire", "truncate") and live[i]:
            rid = rng.choice(sorted(live[i]))
            if not bm.is_swapped(rid):
                if op == "retire":
                    apply(lambda shared, bms: bms[i].free(rid))
                    del live[i][rid]
                else:
                    apply(lambda shared, bms: bms[i].truncate(rid, BS))
                    live[i][rid] = 1
        elif op == "swap" and live[i]:
            rid = rng.choice(sorted(live[i]))
            back = rng.random() < 0.5
            if not bm.is_swapped(rid) and bm.can_swap_out(rid):
                def swap(shared, bms):
                    out = [bms[i].swap_out(rid)]
                    if bms[i].can_swap_in(rid) and back:
                        out.append(bms[i].swap_in(rid))
                    else:
                        bms[i].swap_discard(rid)
                    return out
                if len(apply(swap)) == 1:
                    del live[i][rid]
        apply(state)
        for shared, bms in sides:
            shared.check()
            for b in bms:
                b.check()
    for slots in pins:
        apply(lambda shared, bms: shared.release(slots))
    apply(state)
    sides[1][0].check()


@pytest.mark.parametrize("seed", range(20))
def test_shared_index_two_manager_walk_matches_reference(seed):
    _two_manager_walk(seed)


# ---------------------------------------------------------------------------
# the router against one engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def glm():
    cfg = get_config("glm4_9b", smoke=True)
    return cfg, init_model(cfg, 0, "cpu")


def _engine(glm, shared=None, **kw):
    cfg, params = glm
    kw.setdefault("max_batch", 4)
    kw.setdefault("block_size", 16)
    kw.setdefault("max_len", 96)
    return InferenceEngine(cfg, device="cpu", params=params,
                           shared_index=shared, debug_invariants=True, **kw)


def _fleet(glm, dp, *, shared_slots=64, router_kw=None, **kw):
    shared = SharedPrefixIndex(num_slots=shared_slots)
    engines = [_engine(glm, shared, **kw) for _ in range(dp)]
    return ReplicaRouter(engines, **(router_kw or {})), engines


FULL = SamplingParams(temperature=0.8, top_p=0.9, min_p=0.02,
                      repetition_penalty=1.1, presence_penalty=0.2,
                      frequency_penalty=0.1, logprobs=2, seed=5)
TEMP = SamplingParams(temperature=0.9, top_k=16, seed=3)


def _workload(cfg, n=6):
    """Duplicate prompts (prefix sharing), a temperature row and a full
    sampling row; rids fixed, so sampling streams do not depend on
    placement."""
    common = RNG.integers(0, cfg.vocab_size, 64).astype(np.int32)
    prompts = [common.copy(), common.copy()] + [
        RNG.integers(0, cfg.vocab_size, 32).astype(np.int32)
        for _ in range(n - 2)]
    sampling = {n - 1: FULL, n - 2: TEMP}

    def make():
        return [Request(p.copy(), max_new=6,
                        sampling=sampling.get(i, SamplingParams()),
                        rid=71000 + i) for i, p in enumerate(prompts)]
    return make


def _assert_same(got, want, tag=""):
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid],
                                      err_msg=f"rid {rid} {tag}")


@pytest.mark.parametrize("dp", [1, 2, 3])
def test_dp_byte_identity(glm, dp):
    make = _workload(glm[0])
    arrivals = [0, 2, 3, 3, 5, 6]
    single = _engine(glm)
    want = single.run(make(), arrival_steps=arrivals)
    router, engines = _fleet(glm, dp)
    _assert_same(router.run(make(), arrival_steps=arrivals), want, f"dp={dp}")
    assert sum(router.routed) == 6
    if dp > 1:
        assert all(n > 0 for n in router.routed)
    assert sum(e.stats["tokens"] for e in engines) == single.stats["tokens"]
    assert single.stats["full_sampling_steps"] > 0
    for e in engines:
        assert e.bm.stats().blocks_in_use == 0


def test_dp2_cross_replica_prefix_hit(glm):
    """A prompt served (and retired) on replica 0 is adopted on replica 1
    through the shared index, byte for byte."""
    cfg = glm[0]
    common = RNG.integers(0, cfg.vocab_size, 64).astype(np.int32)
    short = RNG.integers(0, cfg.vocab_size, 32).astype(np.int32)

    def batch1():
        return [Request(common.copy(), max_new=6, rid=72000)]

    def batch2():
        return [Request(common.copy(), max_new=6, rid=72001),
                Request(common.copy(), max_new=6, rid=72002),
                Request(short.copy(), max_new=6, rid=72003)]

    single = _engine(glm)
    want = {**single.run(batch1()), **single.run(batch2())}
    router, engines = _fleet(glm, 2)
    got = router.run(batch1())
    assert router.routed == [1, 0]
    got.update(router.run(batch2()))
    _assert_same(got, want)
    # four full 16-token blocks of the 64-token prompt, adopted
    assert engines[1].stats["shared_hit_blocks"] == 4
    assert engines[0].stats["shared_published_blocks"] >= 4
    assert router.shared_stats()["adopted_blocks"] >= 4
    router.shared_index.check()


def test_dp2_preemption_on_one_replica(glm):
    prompts = [RNG.integers(0, glm[0].vocab_size, 32).astype(np.int32)
               for _ in range(3)]

    def make():
        return [Request(p.copy(), max_new=20, rid=73000 + i)
                for i, p in enumerate(prompts)]

    want = _engine(glm, max_len=128).run(make())
    router, engines = _fleet(glm, 2, max_batch=2, num_blocks=8, max_len=128)
    got = router.run(make())
    assert router.routed == [2, 1]
    assert engines[0].stats["preemptions"] >= 1
    assert engines[1].stats["preemptions"] == 0
    _assert_same(got, want)


def test_dp2_speculative_k2(glm):
    params = glm[1]
    prompts = [RNG.integers(0, glm[0].vocab_size, 32).astype(np.int32)
               for _ in range(3)]

    def make():
        return [Request(p.copy(), max_new=8, rid=74000 + i)
                for i, p in enumerate(prompts)]

    def spec():
        return _engine(glm, max_batch=2, num_speculative_tokens=2,
                       draft_params=params)

    single = spec()
    want = single.run(make())
    assert single.stats["spec_decodes"] > 0
    router = ReplicaRouter([spec(), spec()])
    _assert_same(router.run(make()), want)
    assert sum(e.stats["spec_decodes"] for e in router.engines) > 0


def test_disagg_handoff_byte_identity(glm):
    """Prefill-role probe + decode-role continuation, the KV handed off as
    published hashed blocks: the stitched streams equal the colocated
    engine's, and the decode replica adopts the prompts' blocks."""
    make = _workload(glm[0], n=4)
    arrivals = [0, 3, 3, 6]
    want = _engine(glm).run(make(), arrival_steps=arrivals)
    router, engines = _fleet(glm, 2, router_kw=dict(disaggregate=True))
    _assert_same(router.run(make(), arrival_steps=arrivals), want)
    assert router.handoffs == 4 and router.routed == [4, 0]
    assert engines[1].stats["shared_hit_blocks"] > 0
    assert engines[0].stats["shared_published_blocks"] > 0
    assert engines[1].stats["cache_hit_tokens"] > 0


def test_disagg_stop_and_min_new(glm):
    """A token-1 stop match retires during the probe (no handoff);
    min_new >= 2 defers the check past the probe, as colocated."""
    prompt = RNG.integers(0, glm[0].vocab_size, 32).astype(np.int32)
    t = _engine(glm).run([Request(prompt.copy(), max_new=4,
                                  rid=75000)])[75000]
    stop = ((int(t[0]),),)

    def make():
        sp = SamplingParams(stop=stop)
        return [Request(prompt.copy(), max_new=6, sampling=sp, rid=75001),
                Request(prompt.copy(), max_new=6, sampling=sp, rid=75002,
                        min_new=3)]

    want = _engine(glm).run(make())
    assert len(want[75001]) == 1 and len(want[75002]) >= 3
    router, _ = _fleet(glm, 2, router_kw=dict(disaggregate=True))
    _assert_same(router.run(make()), want)
    assert router.handoffs == 1


def test_router_validation():
    class _Dummy:
        shared_index = None

    with pytest.raises(ValueError):
        ReplicaRouter([])
    for engines, kw in (([_Dummy()], {}), ([_Dummy(), _Dummy()],
                                           {"n_prefill": 2}),
                        ([_Dummy(), _Dummy()], {})):
        with pytest.raises(ValueError):
            ReplicaRouter(engines, disaggregate=True, **kw)

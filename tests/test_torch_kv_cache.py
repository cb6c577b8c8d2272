"""Host serving state of the port against the JAX package: one random
operation tape drives both ``BlockManager``s (tables, refcounts, free
lists and hashes must stay identical), and both ``Scheduler``s plan the
same steps for the same arrivals."""

import random

import numpy as np
import pytest

from repro.serving.kv_cache import BlockManager as JBM
from repro.serving.kv_cache import chain_block_hashes as jax_chain
from repro.serving.scheduler import Request as JReq
from repro.serving.scheduler import Scheduler as JSched
from repro_torch.serving.kv_cache import TRASH_BLOCK, BlockManager
from repro_torch.serving.kv_cache import block_bytes, chain_block_hashes
from repro_torch.serving.scheduler import Request, Scheduler
import torch_cpu  # noqa: F401  (one torch thread)


def _state(bm):
    return (bm._tables, bm._ref, bm._free, bm._hash_of, bm._block_of)


def _differential_walk(tape, n_ops=200):
    """allocate / grow / share / cow / free / register / adopt / deregister
    on both managers in lock step; identical state after every op."""
    NB, BS = 9, 4
    a, b = JBM(num_blocks=NB, block_size=BS), BlockManager(NB, BS)
    rids, next_rid, next_hash = [], [0], [0]

    def draw(n):
        return next(tape) % n

    def both(fn):
        """Apply fn to both managers; equal results or equal exceptions."""
        out = []
        for bm in (a, b):
            try:
                out.append(("ok", fn(bm)))
            except (MemoryError, KeyError) as e:
                out.append(("err", type(e)))
        assert out[0] == out[1], out
        return out[0]

    for _ in range(n_ops):
        op = draw(8)
        if op == 0 or not rids:                         # allocate
            next_rid[0] += 1
            rid, n = next_rid[0], draw(3 * BS + 1)
            if both(lambda bm: bm.allocate(rid, n))[0] == "ok":
                rids.append(rid)
        elif op == 1:                                   # grow
            rid = rids[draw(len(rids))]
            want = len(b.table(rid)) * BS + draw(2 * BS) + 1
            both(lambda bm: bm.ensure(rid, want))
        elif op == 2:                                   # adopt a table
            next_rid[0] += 1
            rid, blocks = next_rid[0], b.table(rids[draw(len(rids))])
            both(lambda bm: bm.adopt(rid, blocks))
            rids.append(rid)
        elif op == 3:                                   # cow
            rid = rids[draw(len(rids))]
            if b.table(rid):
                idx = draw(len(b.table(rid)))
                both(lambda bm: bm.cow(rid, idx))
        elif op == 4:                                   # free
            rid = rids.pop(draw(len(rids)))
            both(lambda bm: bm.free(rid))
        elif op == 5:                                   # register
            rid = rids[draw(len(rids))]
            t = b.table(rid)
            if t:
                next_hash[0] += 1
                blk, h = t[draw(len(t))], next_hash[0]
                both(lambda bm: bm.register(blk, h))
        elif op == 6 and next_hash[0]:                  # adopt a match
            h = draw(next_hash[0]) + 1
            blocks = both(lambda bm: bm.match([h]))[1]
            if blocks:
                next_rid[0] += 1
                rid = next_rid[0]
                both(lambda bm: bm.adopt(rid, blocks))
                rids.append(rid)
        elif op == 7 and b._hash_of:                    # deregister
            blk = sorted(b._hash_of)[draw(len(b._hash_of))]
            both(lambda bm: bm.deregister(blk))
        assert _state(a) == _state(b)
        assert a.stats().__dict__ == b.stats().__dict__
        b.check()
    for rid in rids:
        both(lambda bm: bm.free(rid))
    assert _state(a) == _state(b) and b.num_free == NB - 1


@pytest.mark.parametrize("seed", range(6))
def test_block_manager_matches_reference_random_walk(seed):
    rng = random.Random(seed)
    _differential_walk(iter(lambda: rng.randrange(1 << 20), None))


def test_block_manager_matches_reference_hypothesis():
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    @hyp.given(st.lists(st.integers(0, (1 << 20) - 1), max_size=400))
    @hyp.settings(max_examples=30, deadline=None)
    def prop(tape):
        it = iter(tape)
        _differential_walk(iter(lambda: next(it, 0), None), n_ops=100)

    prop()


def test_chain_hashes_and_block_bytes_match_reference():
    from repro.config import get_config as jax_get_config
    from repro.serving.kv_cache import block_bytes as jax_block_bytes
    from repro_torch.config import get_config
    toks = np.random.default_rng(0).integers(0, 1000, 70).astype(np.int32)
    assert chain_block_hashes(toks, 16) == jax_chain(toks, 16)
    for smoke in (False, True):
        assert block_bytes(get_config("glm4_9b", smoke), 16) == \
            jax_block_bytes(jax_get_config("glm4_9b", smoke), 16)
    assert TRASH_BLOCK == 0


def _plan_key(plan):
    return ([(s, r.rid) for s, r in plan.decodes],
            [(s, r.rid, n) for s, r, n in plan.chunks],
            list(plan.copies), plan.admitted, plan.scheduled_tokens)


@pytest.mark.parametrize("num_blocks,prefix", [(40, True), (7, True),
                                               (7, False)])
def test_scheduler_plans_match_reference(num_blocks, prefix):
    """Same arrivals, same fake model (token = step-dependent constant):
    every step's plan, the preemption count and the cache hits agree.
    A shared prompt prefix exercises prefix hits and full-hit COW; a tight
    pool exercises preemption."""
    rng = np.random.default_rng(num_blocks)
    base = rng.integers(0, 50, 12).astype(np.int32)
    prompts = [base.copy(), base.copy(),
               np.concatenate([base, rng.integers(0, 50, 5).astype(np.int32)]),
               rng.integers(0, 50, 9).astype(np.int32)]
    arrivals = [0, 3, 3, 6]
    kw = dict(enable_prefix_caching=prefix)
    runs = []
    for BM, Sched, Req in ((JBM, JSched, JReq),
                           (BlockManager, Scheduler, Request)):
        bm = BM(num_blocks, 4)
        s = Sched(bm, 2, 8, 2 + 6, 6, **kw)
        reqs = [Req(p.copy(), max_new=6, rid=1000 + i)
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
    if num_blocks == 7:
        assert runs[1][1] > 0                    # preemption exercised
    if prefix and num_blocks == 40:
        assert runs[1][2] > 0                    # prefix hits exercised
        assert any(p[2] for p in runs[1][0])     # a full-hit COW copy


def test_scheduler_refuses_full_sampling_surface():
    """The scheduler serves the full sampling surface now; its validation
    delegates to ``SamplingBuffer.validate``, which refuses what no path
    serves with the reference's messages."""
    from repro_torch.serving.sampling import SamplingBuffer
    from repro_torch.serving.scheduler import SamplingParams
    buf = SamplingBuffer(2, 16, max_stop_len=2, max_logprobs=4)
    s = Scheduler(BlockManager(9, 4), 2, 8, 8, 6, sampling_buffer=buf)
    for sp in (SamplingParams(top_p=0.9), SamplingParams(logprobs=2),
               SamplingParams(stop=((1, 2),)),
               SamplingParams(repetition_penalty=1.1)):
        s.add(Request(np.zeros(4, np.int32), max_new=2, sampling=sp))
    assert len(s.waiting) == 4
    for bad, msg in ((dict(top_p=0.0), "top_p"), (dict(min_p=1.5), "min_p"),
                     (dict(repetition_penalty=0.0), "repetition"),
                     (dict(logprobs=5), "logprobs"),
                     (dict(stop=((1, 2, 3),)), "stop")):
        with pytest.raises(ValueError, match=msg):
            s.add(Request(np.zeros(4, np.int32), max_new=2,
                          sampling=SamplingParams(**bad)))
    with pytest.raises(ValueError, match="min_new"):
        s.add(Request(np.zeros(4, np.int32), max_new=2, min_new=3))
    with pytest.raises(ValueError, match="capacity"):
        s.add(Request(np.zeros(30, np.int32), max_new=8))
    assert len(s.waiting) == 4

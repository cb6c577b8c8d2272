"""Tensor-parallel paged serving on torch.distributed (the port's
``InferenceEngine(mesh=...)``), held against the port's own tp = 1
engine: the JAX package's TP test (``test_serving_tp.py``'s subprocess
run) does not run on this host, and tp = 1 is held against the JAX engine
by the engine tests.

One gloo world of two CPU processes (``torch.multiprocessing``, spawned;
the rendezvous is a file in the test's tmp_path, never a fixed port) runs
every engine case on a mesh ("data", "model") = (1, 2): rank 0 drives
(``run``, ``close``), rank 1 follows (``follow``), each under
``debug_invariants`` (the ranks compare a digest of every step plan). The
test process runs the same cases on one engine. Both ranks' greedy tokens
and scheduling stats must equal the tp = 1 run's, and each rank must hold
half of tp = 1's kv-head cache bytes. glm4_9b (GQA, K = 2) covers a prefix
hit with a boundary COW, preemption-recompute, swap preemption,
speculative k = 2, int8 pools and prefill_pack 4; zamba2_2p7b (hybrid:
replicated slot state, sharded shared-attention pools) and whisper (the
cross K/V sharded by kv head) one run each. Rank 0 also streams through
the async driver with an abort mid-stream: the follower ends with rank
0's tokens and stats, and the other requests' tokens are a tp = 1 run's
without the aborted one. A kv-head count the model axis does not divide
raises the reference's ValueError at construction.
"""

import asyncio
import dataclasses
import pickle

import numpy as np
import pytest
import torch.multiprocessing as mp

import torch_cpu  # noqa: F401  (one torch thread)

WORLD = 2
JOIN_TIMEOUT_S = 240
# max_batch 2, 16-token blocks, 12-token chunks; 7 allocatable blocks
# force preemption once two requests pass 3 blocks each
TIGHT = dict(max_batch=2, block_size=16, max_len=96, num_blocks=8,
             max_num_batched_tokens=2 + 12)
# (name, arch, engine keywords, what the tp = 1 run must show)
CASES = [
    ("prefix_cow_preempt", "glm4_9b", TIGHT,
     ("cow_copies", "preemptions", "cache_hit_tokens")),
    ("swap", "glm4_9b", dict(TIGHT, swap_space_bytes=1 << 20,
                             swap_policy="always"), ("swap_preemptions",)),
    ("speculative_k2", "glm4_9b", dict(num_speculative_tokens=2,
                                       max_batch=2), ("spec_decodes",)),
    ("int8", "glm4_9b", dict(TIGHT, kv_dtype="int8"), ("preemptions",)),
    ("pack4", "glm4_9b", dict(max_batch=4, block_size=16, max_len=96,
                              max_num_batched_tokens=4 + 48,
                              prefill_pack=4), ("prefill_chunks",)),
    ("zamba2", "zamba2_2p7b", dict(max_batch=2, max_len=96), ("steps",)),
    ("whisper", "whisper_large_v3", dict(max_batch=2, max_len=64),
     ("encodes",)),
]
SCHED_STATS = ("steps", "prefill_chunks", "preemptions", "tokens",
               "prefill_tokens", "quantum_dropped_tokens", "cache_hit_tokens",
               "cow_copies", "requests", "requests_done", "spec_decodes",
               "spec_emitted", "stop_hits", "full_sampling_steps",
               "peak_block_utilization", "peak_blocks_in_use", "aborts",
               "swap_preemptions", "swap_ins", "swapped_out_blocks",
               "swapped_in_blocks", "encodes")


def _requests(cfg):
    """Prompts sharing a 32-token prefix (one of them exactly the prefix:
    two full cached blocks, written again by its decode: a COW) and a
    fresh one, staggered; whisper's with seeded frames."""
    from repro_torch.serving import Request
    rng = np.random.default_rng(11)
    prefix = rng.integers(0, cfg.vocab_size, 32).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 8)
                               .astype(np.int32)]),
               prefix.copy(),
               np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 13)
                               .astype(np.int32)]),
               rng.integers(0, cfg.vocab_size, 20).astype(np.int32)]
    frames, max_new = [None] * 4, 20
    if cfg.encoder_layers:
        prompts, max_new = [p[:12] for p in prompts], 12
        frames = [rng.normal(0, 1, (cfg.encoder_seq_len, cfg.d_model))
                  .astype(np.float32) for _ in prompts]
    return ([Request(p, max_new=max_new, frames=f)
             for p, f in zip(prompts, frames)], [0, 5, 9, 9])


def _kv_head_bytes(cache) -> int:
    from repro_torch.spmd.sharding import KV_HEAD_LEAVES
    total = 0
    for name, t in cache.items():
        if isinstance(t, dict):
            total += _kv_head_bytes(t)
        elif name in KV_HEAD_LEAVES:
            total += t.numel() * t.element_size()
    return total


def _serve(arch, kw, mesh=None) -> dict:
    """One case on one engine (tp = 1) or on this rank of ``mesh``:
    tokens by request order, scheduling stats, kv-head cache bytes."""
    from repro_torch.config import get_config
    from repro_torch.serving import InferenceEngine
    cfg = get_config(arch, smoke=True)
    eng = InferenceEngine(cfg, device="cpu", mesh=mesh,
                          debug_invariants=True, **kw)
    reqs, arrivals = _requests(cfg)
    if eng.group is None or eng.group.rank == 0:
        outs = eng.run(reqs, arrival_steps=arrivals)
        eng.close()
        toks = [outs[r.rid].tolist() for r in reqs]
    else:
        outs = eng.follow()
        toks = [outs[rid].tolist() for rid in sorted(outs)]
    s = eng.stats
    return {"tokens": toks, "sched": {k: s[k] for k in SCHED_STATS},
            "kv_head_bytes": _kv_head_bytes(eng.cache), "tp": s["tp"],
            "gathers": s["tp_gathers"]}


def _stream_with_abort(eng, reqs, arrivals):
    """Rank 0 streams ``reqs`` through the async driver (all submitted
    before the step thread starts, as ``run`` sees them), aborting
    request 0 after its fourth token. Returns every request's tokens."""
    from repro_torch.serving.frontend import AsyncEngineDriver

    async def go():
        drv = AsyncEngineDriver(eng)
        streams = [await drv.submit(r, arrival_step=t)
                   for r, t in zip(reqs, arrivals)]
        await drv.start()

        async def pull(i, s):
            toks = []
            async for ev in s:
                toks.append(ev.token)
                if i == 0 and len(toks) == 4:
                    drv.abort(s.request.rid)
            return toks

        out = await asyncio.gather(*(pull(i, s)
                                     for i, s in enumerate(streams)))
        await drv.aclose()
        return out

    return asyncio.run(go())


def _serve_driver(mesh) -> dict:
    """glm4 under TIGHT through the driver on rank 0 (with an abort), the
    follower as always."""
    from repro_torch.config import get_config
    from repro_torch.serving import InferenceEngine
    cfg = get_config("glm4_9b", smoke=True)
    eng = InferenceEngine(cfg, device="cpu", mesh=mesh,
                          debug_invariants=True, **TIGHT)
    reqs, arrivals = _requests(cfg)
    if eng.group.rank == 0:
        toks = _stream_with_abort(eng, reqs, arrivals)
        eng.close()
    else:
        outs = eng.follow()
        toks = [outs[rid].tolist() for rid in sorted(outs)]
    return {"tokens": toks,
            "sched": {k: eng.stats[k] for k in SCHED_STATS}}


def _rank(rank, world, init_method, out_dir):
    """One rank of the world: every case on the (1, world) mesh, then the
    indivisible-head refusals; the results pickled into ``out_dir``."""
    import torch
    from repro_torch.config import get_config
    from repro_torch.launch.mesh import init_rank, make_host_mesh
    from repro_torch.serving import InferenceEngine
    torch.set_num_threads(1)
    backend = init_rank(rank, world, init_method, "cpu", timeout_s=120)
    mesh = make_host_mesh(1, world, "cpu")
    res = {"backend": backend, "cases": {}}
    for name, arch, kw, _ in CASES:
        res["cases"][name] = _serve(arch, kw, mesh)
    res["driver"] = _serve_driver(mesh)
    glm = get_config("glm4_9b", smoke=True)
    odd = dataclasses.replace(glm, num_kv_heads=1)
    errors = []
    for cfg, kw in ((odd, {}), (glm, dict(draft_cfg=odd,
                                          num_speculative_tokens=2))):
        try:
            InferenceEngine(cfg, device="cpu", mesh=mesh, **kw)
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    res["errors"] = errors
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Both ranks' results; fails unless both exit 0 within the join
    timeout."""
    d = tmp_path_factory.mktemp("tp_world")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank,
                         args=(r, WORLD, f"file://{d}/rendezvous", str(d)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_TIMEOUT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    assert not alive, f"ranks still running after {JOIN_TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * WORLD, \
        [p.exitcode for p in procs]
    out = []
    for r in range(WORLD):
        with open(d / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.mark.parametrize("name,arch,kw,shows", CASES,
                         ids=[c[0] for c in CASES])
def test_tp2_equals_tp1(world, name, arch, kw, shows):
    """Every rank's greedy tokens and scheduling stats equal one engine's,
    byte for byte; each rank holds half the kv-head bytes and gathered its
    heads every step."""
    one = _serve(arch, kw)
    for stat in shows:
        assert one["sched"][stat] > 0, (name, stat, one["sched"])
    for rank, res in enumerate(world):
        assert res["backend"] == "gloo"
        mine = res["cases"][name]
        assert mine["tokens"] == one["tokens"], (rank, name)
        assert mine["sched"] == one["sched"], (rank, name)
        assert mine["tp"] == WORLD and mine["gathers"] > 0
        assert mine["kv_head_bytes"] * WORLD == one["kv_head_bytes"]


def test_driver_with_abort_on_rank0(world):
    """Rank 0 streams through the async driver and aborts request 0 after
    its fourth token: the follower ends with the same tokens (the aborted
    request's partial stream too) and scheduling stats, one abort; the
    other requests' tokens equal a tp = 1 run without request 0."""
    from repro_torch.config import get_config
    from repro_torch.serving import InferenceEngine
    lead, follow = world[0]["driver"], world[1]["driver"]
    assert lead == follow
    assert lead["sched"]["aborts"] == 1
    assert 4 <= len(lead["tokens"][0]) < 20
    cfg = get_config("glm4_9b", smoke=True)
    eng = InferenceEngine(cfg, device="cpu", **TIGHT)
    reqs, arrivals = _requests(cfg)
    outs = eng.run(reqs[1:], arrival_steps=arrivals[1:])
    assert lead["tokens"][1:] == [outs[r.rid].tolist() for r in reqs[1:]]


def test_indivisible_kv_heads_raise_reference_error(world):
    """A kv-head count (target or draft) the model axis does not divide:
    the reference's ValueError at construction, on every rank."""
    from repro.spmd.sharding import paged_pool_pspec as jax_pspec
    with pytest.raises(ValueError) as ref:
        jax_pspec(1, WORLD)
    for res in world:
        assert res["errors"] == [str(ref.value)] * 2

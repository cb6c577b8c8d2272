"""The port's SSM and hybrid serving (``SSMRunner`` for mamba2_370m,
``HybridRunner`` for zamba2_2p7b) at smoke size on the CPU.

Against the JAX package: the same bf16 parameters and requests give the
same greedy tokens, through chunked prefill with quantized chunk lengths,
staggered arrivals and (zamba2) preemption; a token may differ only where
the port's top-2 logit margin at the first differing step is below the
bf16 tolerance (the two frameworks round bf16 activations at other
places). Scheduler plans with ``chunk_quantum`` and without a block
manager equal the JAX scheduler's step for step.

Inside the port, copies of the JAX package's engine tests
(``tests/test_serving.py``): quantized chunk lengths, a hybrid preemption
victim recomputing from zeroed slot state, no horizon validation for slot
state; chunked == monolithic; and what the slot-state runners refuse."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jax_get_config
from repro.models import api as japi
from repro.serving import InferenceEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving.cache import SlotStateCache as JSlots
from repro.serving.kv_cache import BlockManager as JBM
from repro.serving.scheduler import Request as JReq
from repro.serving.scheduler import Scheduler as JSched
from repro_torch.config import get_config
from repro_torch.models import transformer
from repro_torch.models.api import params_from_jax
from repro_torch.serving import InferenceEngine, Request
from repro_torch.serving.cache import SlotStateCache
from repro_torch.serving.kv_cache import BlockManager
from repro_torch.serving.runners import make_runner
from repro_torch.serving.scheduler import Scheduler
import torch_cpu  # noqa: F401  (one torch thread)

BF16_TOL = 1e-2
ARCHS = ("mamba2_370m", "zamba2_2p7b")
# budget 2 + 13: with a decode running a chunk gets 12 tokens, quantized
# down to the smoke SSD chunk of 8 (the final chunk of a prompt exempt)
QUANT = dict(max_batch=2, block_size=16, max_len=96,
             max_num_batched_tokens=2 + 13)


@pytest.fixture(scope="module")
def models():
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out = {}
    for arch in ARCHS:
        cfg = jax_get_config(arch, smoke=True)
        with jax.set_mesh(mesh):
            pf, _ = japi.init_model(cfg, jax.random.key(0))
            tree = jax.tree.map(lambda x: np.asarray(x.astype(jnp.bfloat16)),
                                pf)
        tcfg = get_config(arch, smoke=True)
        out[arch] = (cfg, mesh, tree, tcfg,
                     params_from_jax(tree, tcfg, "cpu"))
    return out


def _prompts(cfg, n, length, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, length).astype(np.int32)
            for _ in range(n)]


def _run_port(models, arch, prompts, arrivals=None, max_new=8, **kw):
    _, _, _, tcfg, params = models[arch]
    eng = InferenceEngine(tcfg, device="cpu", params=params,
                          debug_invariants=True, **kw)
    reqs = [Request(p.copy(), max_new=max_new) for p in prompts]
    outs = eng.run(reqs, arrival_steps=arrivals)
    return eng, [outs[r.rid].tolist() for r in reqs]


def _last_logits(params, cfg, tokens):
    """The port's fp32 logits after ``tokens``, by one monolithic chunk
    from fresh state (block 0 is the trash block)."""
    n, bs = len(tokens), 16
    nb = -(-n // bs)
    cache = make_runner(cfg).init_cache(nb + 1, bs, 1, "cpu")

    def i32(x):
        return torch.tensor(x, dtype=torch.int32)

    batch = {"tokens": i32([list(tokens)]), "q_start": i32([0]),
             "q_lens": i32([n]), "block_tables": i32([list(range(1, nb + 1))]),
             "ctx_lens": i32([n])}
    with torch.no_grad():
        lg, _ = transformer.prefill_chunk_paged(params, cache, batch, cfg)
    return lg[0, :cfg.vocab_size]


def _assert_same_or_near_tie(params, cfg, prompt, ours, ref):
    if ours == ref:
        return
    i = next(j for j, (a, b) in enumerate(zip(ours, ref)) if a != b)
    lg = _last_logits(params, cfg,
                      np.concatenate([prompt, np.asarray(ours[:i])]))
    top2 = torch.topk(lg, 2)
    margin = float(top2.values[0] - top2.values[1])
    assert set(top2.indices.tolist()) == {ours[i], ref[i]}, (i, top2)
    assert margin < BF16_TOL, f"step {i}: margin {margin:.4g}"


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_matches_reference(models, arch):
    """Staggered arrivals and quantized chunked prefill in one run of each
    package; zamba2 also preempts (7 allocatable blocks of 16)."""
    cfg, mesh, tree, tcfg, params = models[arch]
    prompts = _prompts(cfg, 4, 40, 1)
    arrivals = [0, 0, 3, 5]
    kw = dict(QUANT)
    if arch == "zamba2_2p7b":
        kw["num_blocks"] = 8
    jeng = JaxEngine(cfg, mesh, params=jax.tree.map(jnp.asarray, tree),
                     debug_invariants=True, **kw)
    jreqs = [JaxRequest(p.copy(), max_new=20) for p in prompts]
    jouts = jeng.run(jreqs, arrival_steps=arrivals)
    eng, outs = _run_port(models, arch, prompts, arrivals, max_new=20, **kw)
    assert type(eng.runner).__name__ == ("SSMRunner" if arch == "mamba2_370m"
                                         else "HybridRunner")
    assert (eng.bm is None) == (arch == "mamba2_370m")
    assert eng.stats["prefill_chunks"] > len(prompts)            # chunked
    assert eng.stats["quantum_dropped_tokens"] > 0               # quantized
    if arch == "zamba2_2p7b":
        assert eng.stats["preemptions"] >= 1
    for p, ours, jr in zip(prompts, outs, jreqs):
        assert len(ours) == 20 and all(0 <= t < cfg.vocab_size for t in ours)
        _assert_same_or_near_tie(params, tcfg, p, ours,
                                 jouts[jr.rid].tolist())
    if all(o == jouts[jr.rid].tolist() for o, jr in zip(outs, jreqs)):
        for key in ("preemptions", "prefill_chunks", "steps", "tokens",
                    "quantum_dropped_tokens", "kv_cache_mib"):
            assert eng.stats[key] == jeng.stats[key], key


def _plan_key(plan):
    return ([(s, r.rid) for s, r in plan.decodes],
            [(s, r.rid, n) for s, r, n in plan.chunks],
            list(plan.copies), plan.admitted, plan.scheduled_tokens)


@pytest.mark.parametrize("num_blocks", [None, 10])
def test_scheduler_plans_match_reference(num_blocks):
    """``chunk_quantum`` 8 with slot caches, without a block manager (pure
    SSM) and with a tight one (hybrid: preemption frees the slot): every
    plan, the slot bindings and the dropped-token count agree."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 50, n).astype(np.int32)
               for n in (21, 9, 30, 17)]
    arrivals = [0, 0, 2, 6]
    runs = []
    for BM, Sched, Req, Slots in ((JBM, JSched, JReq, JSlots),
                                  (BlockManager, Scheduler, Request,
                                   SlotStateCache)):
        bm = None if num_blocks is None else BM(num_blocks, 4)
        slots = Slots(2)
        s = Sched(bm, 2, 16, 2 + 13, 13, enable_prefix_caching=False,
                  chunk_quantum=8, slot_cache=slots)
        reqs = [Req(p.copy(), max_new=6, rid=2000 + i)
                for i, p in enumerate(prompts)]
        plans, step, pending = [], 0, list(zip(arrivals, reqs))
        while pending or s.has_work:
            while pending and pending[0][0] <= step:
                s.add(pending.pop(0)[1])
            plan = s.schedule()
            plans.append((_plan_key(plan), dict(slots._slot_of)))
            for slot, r in plan.decodes:
                r.num_computed += 1
                r.out.append((step * 7 + r.rid) % 50)
                if r.done:
                    s.retire(slot)
            for slot, r, n in plan.chunks:
                r.num_computed += n
                if r.num_computed == r.context_len:
                    r.out.append((step * 7 + r.rid) % 50)
                    if r.done:
                        s.retire(slot)
            step += 1
            assert step < 500
        runs.append((plans, s.n_preemptions, s.quantum_dropped_tokens,
                     [r.out for r in reqs]))
    assert runs[0] == runs[1]
    assert runs[1][2] > 0                       # quantum rounding exercised
    chunk_lens = [c[2] for p in runs[1][0] for c in p[0][1]]
    assert any(n % 8 for n in chunk_lens) and 8 in chunk_lens
    if num_blocks is not None:
        assert runs[1][1] > 0                   # preemption exercised


def test_engine_ssm_quantized_chunk_lengths(models):
    """Non-final SSM chunks are quantized to the SSD chunk size even when
    the leftover budget is not a multiple; outputs equal a run whose
    prompts fit one chunk."""
    cfg = models["mamba2_370m"][0]
    prompts = _prompts(cfg, 2, 24, 2)
    chunks = []
    eng = InferenceEngine(models["mamba2_370m"][3], device="cpu",
                          params=models["mamba2_370m"][4],
                          debug_invariants=True, **QUANT)
    schedule = eng.sched.schedule

    def spy():
        plan = schedule()
        chunks.extend((r.num_computed, n, r.context_len)
                      for _, r, n in plan.chunks)
        return plan

    eng.sched.schedule = spy
    reqs = [Request(p.copy(), max_new=6) for p in prompts]
    outs = eng.run(reqs)
    got = [outs[r.rid].tolist() for r in reqs]
    for lo, n, total in chunks:
        assert lo % 8 == 0 and (n % 8 == 0 or lo + n == total), chunks
    assert eng.stats["quantum_dropped_tokens"] > 0
    _, mono = _run_port(models, "mamba2_370m", prompts, max_new=6,
                        max_batch=2, block_size=16, max_len=96,
                        max_num_batched_tokens=2 + 48)
    assert got == mono


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_equals_monolithic(models, arch):
    prompts = _prompts(models[arch][0], 3, 27, 4)
    _, chunked = _run_port(models, arch, prompts, [0, 1, 1], **QUANT)
    eng, mono = _run_port(models, arch, prompts, [0, 1, 1], max_batch=2,
                          block_size=16, max_len=96,
                          max_num_batched_tokens=2 + 32)
    assert eng.stats["prefill_chunks"] == len(prompts)
    assert chunked == mono


def test_engine_zamba2_preemption_resets_slot_state(models):
    """A hybrid victim of block-pool preemption recomputes from zeroed
    slot state: greedy outputs stay preemption-invariant."""
    prompts = _prompts(models["zamba2_2p7b"][0], 2, 32, 5)
    _, want = _run_port(models, "zamba2_2p7b", prompts, max_new=20,
                        max_batch=2, block_size=16, max_len=96)
    # 7 allocatable blocks of 16: two ctx-33 requests take 3 blocks each;
    # growth past 48 tokens forces preempting the newer one
    eng, got = _run_port(models, "zamba2_2p7b", prompts, max_new=20,
                         max_batch=2, block_size=16, max_len=96,
                         num_blocks=8)
    assert eng.stats["preemptions"] >= 1
    assert got == want


def test_engine_ssm_no_horizon_validation(models):
    """Slot state has no block horizon: an SSM request whose prompt +
    max_new exceeds max_len is served, while the paged transformer still
    rejects one."""
    prompts = _prompts(models["mamba2_370m"][0], 1, 24, 6)
    eng, outs = _run_port(models, "mamba2_370m", prompts, max_new=24,
                          max_batch=2, block_size=16, max_len=32,
                          max_num_batched_tokens=2 + 16)
    assert len(outs[0]) == 24 and eng.bm is None
    dense = InferenceEngine(get_config("glm4_9b", smoke=True), device="cpu",
                            max_batch=2, block_size=16, max_len=32)
    with pytest.raises(ValueError, match="capacity"):
        dense.run([Request(prompts[0].copy(), max_new=24)])


@pytest.mark.parametrize("arch", ARCHS)
def test_slot_runners_refuse_and_gate(models, arch):
    """bf16 pools only (the JAX message); no prefix caching and no packed
    prefill (forced off); slot-state bytes in the engine's stats."""
    _, _, _, tcfg, params = models[arch]
    with pytest.raises(ValueError, match="slot state has no quantized"):
        InferenceEngine(tcfg, device="cpu", params=params, kv_dtype="int8")
    eng = InferenceEngine(tcfg, device="cpu", params=params, max_batch=2,
                          prefill_pack=4, enable_prefix_caching=True)
    assert eng.prefill_pack == 1 and not eng.sched.enable_prefix_caching
    assert eng.slot_cache.n_slots == 2 and eng.sched.chunk_quantum == 8
    assert eng.stats["slot_state_mib"] > 0
    assert eng.stats["kv_cache_mib"] >= eng.stats["slot_state_mib"]
    with pytest.raises(ValueError, match="attention-only"):
        transformer.prefill_chunk_ragged(params, eng.cache, {}, tcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_on_cpu(capsys, arch):
    from repro_torch.launch import serve
    serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                "--requests", "3", "--max-new", "4", "--prompt-len", "20"])
    out = capsys.readouterr().out
    runner = "SSMRunner" if arch == "mamba2_370m" else "HybridRunner"
    assert f"runner={runner}" in out and "slot_state_mib=" in out
    assert "[serve] sample output ids:" in out

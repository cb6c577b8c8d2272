"""The port's continuous-batching engine at glm4 smoke size on the CPU.

Against the JAX package: the same bf16 parameters and requests give the
same greedy tokens through prefix hits with boundary copy-on-write,
preemption-recompute and chunked prefill. A token may differ only where
the port's top-2 logit margin at the first differing step is below the
bf16 tolerance (the two frameworks round bf16 activations at other
places); after that the streams legitimately part.

Inside the port: the JAX package's own invariants hold (chunked ==
monolithic, preempted == uninterrupted, prefix-hit == cold). The
constructor raises the reference's ValueErrors for the host tiers on a
runner with slot state and for a shared index without prefix caching,
and refuses a mesh by name (ROADMAP.md queue 1 item 12)."""

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
from repro_torch.serving.kv_cache import init_paged_cache

BF16_TOL = 1e-2
# max_batch 2, 16-token blocks, 12-token chunks; 7 allocatable blocks
# force preemption once two requests pass 3 blocks each
TIGHT = dict(max_batch=2, block_size=16, max_len=96, num_blocks=8,
             max_num_batched_tokens=2 + 12)


@pytest.fixture(scope="module")
def setup():
    cfg = jax_get_config("glm4_9b", smoke=True)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    with jax.set_mesh(mesh):
        pf, _ = japi.init_model(cfg, jax.random.key(0))
        tree = jax.tree.map(lambda x: np.asarray(x.astype(jnp.bfloat16)), pf)
    tcfg = get_config("glm4_9b", smoke=True)
    rng = np.random.default_rng(11)
    prefix = rng.integers(0, cfg.vocab_size, 32).astype(np.int32)
    tail = rng.integers(0, cfg.vocab_size, 8).astype(np.int32)
    prompts = [np.concatenate([prefix, tail]),
               prefix.copy(),                # two full cached blocks: COW
               np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 13)
                               .astype(np.int32)]),
               rng.integers(0, cfg.vocab_size, 20).astype(np.int32)]
    return cfg, mesh, tree, tcfg, prompts


def _port(setup, **kw):
    _, _, tree, tcfg, _ = setup
    return InferenceEngine(tcfg, device="cpu",
                           params=params_from_jax(tree, tcfg, "cpu"),
                           debug_invariants=True, **kw)


def _run_port(setup, prompts, arrivals=None, max_new=20, **kw):
    eng = _port(setup, **kw)
    reqs = [Request(p.copy(), max_new=max_new) for p in prompts]
    outs = eng.run(reqs, arrival_steps=arrivals)
    return eng, [outs[r.rid].tolist() for r in reqs]


def _last_logits(params, cfg, tokens):
    """The port's fp32 logits after ``tokens``, by one monolithic chunk."""
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


def _assert_same_or_near_tie(eng, prompt, ours, ref):
    """Equal token streams, or a first difference at a near-tie."""
    if ours == ref:
        return
    i = next(j for j, (a, b) in enumerate(zip(ours, ref)) if a != b)
    lg = _last_logits(eng.params, eng.cfg,
                      np.concatenate([prompt, np.asarray(ours[:i])]))
    top2 = torch.topk(lg, 2)
    margin = float(top2.values[0] - top2.values[1])
    assert set(top2.indices.tolist()) == {ours[i], ref[i]}, (i, top2)
    assert margin < BF16_TOL, f"step {i}: margin {margin:.4g}"


def test_engine_greedy_matches_reference(setup):
    """Prefix hits with a boundary COW, preemption and chunked prefill, in
    one run of each package."""
    cfg, mesh, tree, tcfg, prompts = setup
    arrivals = [0, 5, 9, 9]
    jeng = JaxEngine(cfg, mesh, params=jax.tree.map(jnp.asarray, tree),
                     debug_invariants=True, **TIGHT)
    jreqs = [JaxRequest(p.copy(), max_new=20) for p in prompts]
    jouts = jeng.run(jreqs, arrival_steps=arrivals)
    eng, outs = _run_port(setup, prompts, arrivals, **TIGHT)
    assert eng.stats["preemptions"] >= 1
    assert eng.stats["cache_hit_tokens"] > 0 and eng.stats["cow_copies"] >= 1
    assert eng.stats["prefill_chunks"] > len(prompts)       # chunked
    for p, ours, jr in zip(prompts, outs, jreqs):
        assert len(ours) == 20 and all(0 <= t < cfg.vocab_size for t in ours)
        _assert_same_or_near_tie(eng, p, ours, jouts[jr.rid].tolist())
    if all(o == jouts[jr.rid].tolist() for o, jr in zip(outs, jreqs)):
        for key in ("preemptions", "cache_hit_tokens", "cow_copies",
                    "prefill_chunks", "steps", "tokens"):
            assert eng.stats[key] == jeng.stats[key], key


def test_chunked_equals_monolithic(setup):
    prompts = setup[4]
    _, chunked = _run_port(setup, prompts, max_batch=2, block_size=16,
                           max_len=96, max_num_batched_tokens=2 + 12)
    eng, mono = _run_port(setup, prompts, max_batch=2, block_size=16,
                          max_len=96, max_num_batched_tokens=2 + 96)
    assert eng.stats["prefill_chunks"] <= len(prompts)
    assert chunked == mono


def test_preempted_equals_uninterrupted(setup):
    prompts = setup[4][2:]
    _, free = _run_port(setup, prompts, max_batch=2, block_size=16,
                        max_len=96)
    eng, tight = _run_port(setup, prompts, **TIGHT)
    assert eng.stats["preemptions"] >= 1
    assert tight == free


def test_prefix_hit_equals_cold(setup):
    prompts = setup[4]
    eng, hit = _run_port(setup, prompts, [0, 5, 9, 9], max_batch=2,
                         block_size=16, max_len=96)
    assert eng.stats["cache_hit_tokens"] > 0 and eng.stats["cow_copies"] >= 1
    eng, cold = _run_port(setup, prompts, [0, 5, 9, 9], max_batch=2,
                          block_size=16, max_len=96,
                          enable_prefix_caching=False)
    assert eng.stats["cache_hit_tokens"] == 0
    assert hit == cold


def test_temperature_replays_and_stats(setup):
    prompts = setup[4][:2]

    def run():
        eng = _port(setup, max_batch=2, block_size=16, max_len=96)
        reqs = [Request(p.copy(), max_new=6,
                        sampling=SamplingParams(temperature=0.8, top_k=20,
                                                seed=5), rid=500 + i)
                for i, p in enumerate(prompts)]
        outs = eng.run(reqs)
        return eng, [outs[r.rid].tolist() for r in reqs]

    eng, a = run()
    _, b = run()
    assert a == b
    s = eng.stats
    assert s["requests_done"] == 2 and s["tokens"] == 12
    assert eng.hist["e2e_steps"].count == 2 and s["tok_s"] > 0


def test_latency_records_stay_bounded(setup, monkeypatch):
    """Past the cap, completed latency records are dropped, oldest first;
    the histograms keep every retirement."""
    from repro_torch.serving import engine as engine_mod
    monkeypatch.setattr(engine_mod, "LATENCY_RECORD_CAP", 2)
    eng = _port(setup, max_batch=2, block_size=16, max_len=96)
    reqs = [Request(p.copy(), max_new=3) for p in setup[4]]
    eng.run(reqs)
    lat = eng.stats["latency"]
    assert eng.stats["requests_done"] == len(reqs) == 4
    assert len(lat) <= 2 and all("done_step" in r for r in lat.values())
    assert reqs[0].rid not in lat and reqs[-1].rid in lat
    assert eng.hist["e2e_steps"].count == len(reqs)


@pytest.mark.parametrize("arch,kw,exc,match", [
    ("mamba2_370m", {"swap_space_bytes": 1 << 20}, ValueError,
     "pure paged-KV runner"),
    ("zamba2_2p7b", {"shared_index": object()}, ValueError,
     "pure paged-KV runner"),
    ("glm4_9b", {"shared_index": object(), "enable_prefix_caching": False},
     ValueError, "enable_prefix_caching=True"),
    ("glm4_9b", {"swap_policy": "sometimes"}, ValueError, "swap_policy"),
    ("glm4_9b", {"mesh": object()}, NotImplementedError,
     "ROADMAP.md queue 1 item 12")])
def test_engine_refuses_unported_options(arch, kw, exc, match):
    """The reference's ValueErrors: no host tier for a runner with slot
    state (its state has no block-swap form), no shared index without
    prefix caching; an unknown swap policy; a mesh is not ported."""
    with pytest.raises(exc, match=match):
        InferenceEngine(get_config(arch, smoke=True), device="cpu", **kw)


@pytest.mark.parametrize("target,draft,k,match", [
    ("mamba2_370m", "glm4_9b", 2, "paged-transformer target and draft"),
    ("glm4_9b", "zamba2_2p7b", 2, "paged-transformer target and draft"),
    ("glm4_9b", "glm4_9b:v300", 2, "draft vocab 300 != target vocab"),
    ("glm4_9b", "glm4_9b", -1, "spec_tokens=-1"),
])
def test_make_runner_refuses_bad_pairs(target, draft, k, match):
    """make_runner refuses the speculative pairs the reference refuses: a
    target or draft that is not a paged transformer, a vocabulary
    mismatch, a negative k. A good pair (a self-draft, with k or with a
    draft config alone) gives a SpeculativeRunner."""
    import dataclasses
    from repro_torch.serving.runners import SpeculativeRunner, make_runner
    arch, _, vocab = draft.partition(":v")
    dcfg = get_config(arch, smoke=True)
    if vocab:
        dcfg = dataclasses.replace(dcfg, vocab_size=int(vocab))
    with pytest.raises(ValueError, match=match):
        make_runner(get_config(target, smoke=True), draft_cfg=dcfg,
                    num_speculative_tokens=k)
    cfg = get_config("glm4_9b", smoke=True)
    for kw in ({"num_speculative_tokens": 2}, {"draft_cfg": cfg}):
        assert type(make_runner(cfg, **kw)) is SpeculativeRunner


def test_serve_cli_runs_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "glm4_9b", "--smoke", "--device", "cpu",
                "--requests", "3", "--max-new", "4", "--prompt-len", "20",
                "--profile", "3"])
    out = capsys.readouterr().out
    assert out.count("[profile]") == 4 and "busy share" in out
    assert "device=cpu" in out and "runner=TransformerRunner" in out
    assert "[serve] sample output ids:" in out
    serve.main(["--arch", "glm4_9b", "--smoke", "--device", "cpu",
                "--requests", "4", "--max-new", "3", "--prompt-len", "20",
                "--rate", "8", "--prefill-pack", "4", "--kv-dtype", "int8"])
    out = capsys.readouterr().out
    assert "kv_dtype=int8 prefill_pack=4" in out
    assert "[serve] sample output ids:" in out

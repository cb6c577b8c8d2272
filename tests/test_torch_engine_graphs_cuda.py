"""The engine's CUDA graphs on the card, against the same engine run
eagerly (``cuda_graphs=False``) on the same card, at smoke size. Every
test skips without a CUDA card. The file imports neither jax nor the JAX
package, so on a machine with a card and without jax it runs alone:

  PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_engine_graphs_cuda.py

Graph and eager run one step body on the same inputs, so tokens (and
logprobs) must be byte-identical (no tolerance): glm4_9b (head dim 16 at
smoke size, the paged kernels' hd-16 route), gemma2_27b (hd 16 too: its
16-token window, both softcaps and scale 1/4 through the kernels),
mamba2_370m and zamba2_2p7b,
an int8 pool with prefill_pack 4, a run that preempts, a temperature run
whose draws replay, every sampling mode (greedy, plain, full) on every
runner, and the speculative runner in each mode. Each graph engine
captures at most one graph per (shape, mode) and replays every step. The
slot-state chunk's invariants hold under replay.
"""

import numpy as np
import pytest
import torch

from repro_torch.config import get_config
from repro_torch.models.api import init_model
from repro_torch.serving import InferenceEngine, Request, SamplingParams

SMALL = dict(max_batch=2, block_size=16, max_len=96,
             max_num_batched_tokens=2 + 12)
# 7 allocatable blocks of 16: two requests of 32 + 20 tokens need 8, so
# the newer one is preempted
TIGHT = dict(max_batch=2, block_size=16, max_len=96, num_blocks=8)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _prompts(cfg, n, length, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, length).astype(np.int32)
            for _ in range(n)]


def _modes(sampling):
    """The sampling modes a step over these requests can run in."""
    return {"full" if sp.needs_pipeline else
            "plain" if sp.temperature > 0 else "greedy" for sp in sampling}


def _both(arch, prompts, arrivals=None, max_new=12, sampling=None,
          logprobs=None, **kw):
    """The same requests through a graph engine and an eager one, same
    weights. ``sampling``: one SamplingParams for all, or one per request.
    Returns (graph tokens, eager tokens, graph engine); with a
    ``logprobs`` dict, fills it with each run's logprobs by graphs."""
    cfg = get_config(arch, smoke=True)
    params = init_model(cfg, 0, "cuda")
    if not isinstance(sampling, (list, tuple)):
        sampling = [sampling or SamplingParams()] * len(prompts)
    outs = {}
    for graphs in (True, False):
        eng = InferenceEngine(cfg, device="cuda", params=params,
                              cuda_graphs=graphs, debug_invariants=True,
                              **kw)
        reqs = [Request(p.copy(), max_new=max_new, rid=100 + i, sampling=sp)
                for i, (p, sp) in enumerate(zip(prompts, sampling))]
        seen = []
        eng.on_token = lambda r, t, lp: seen.append((r.rid, t, lp))
        got = eng.run(reqs, arrival_steps=arrivals)
        outs[graphs] = [got[r.rid].tolist() for r in reqs]
        if logprobs is not None:
            logprobs[graphs] = seen
        if graphs:
            graph_eng = eng
            s = eng.stats
            # one graph per (shape, mode), of the modes the requests need
            # only (greedy requests: the greedy pair)
            used = {m for _, m in eng.graphs.graphs}
            assert used <= _modes(sampling)
            assert 1 <= s["graph_captures"] == len(eng.graphs.graphs) \
                <= 2 * len(used)
            assert sum(s["graph_replays"].values()) == s["steps"]
        else:
            assert eng.graphs is None and eng.stats["graph_captures"] == 0
    return outs[True], outs[False], graph_eng


@pytest.mark.parametrize("arch", ["glm4_9b", "gemma2_27b", "mamba2_370m",
                                  "zamba2_2p7b"])
def test_cuda_graph_equals_eager(arch):
    _card()
    cfg = get_config(arch, smoke=True)
    prompts = _prompts(cfg, 4, 27, 1)
    g, e, eng = _both(arch, prompts, [0, 0, 3, 5], **SMALL)
    assert g == e
    assert eng.stats["graph_captures"] == 2
    assert eng.stats["prefill_chunks"] > len(prompts)          # chunked


def test_cuda_graph_equals_eager_int8_packed():
    _card()
    cfg = get_config("glm4_9b", smoke=True)
    prompts = _prompts(cfg, 4, 30, 2)
    g, e, eng = _both("glm4_9b", prompts, [0, 0, 0, 4], prefill_pack=4,
                      kv_dtype="int8", max_batch=2, block_size=16,
                      max_len=96, max_num_batched_tokens=2 + 32)
    assert g == e
    assert eng.cache["k"].dtype == torch.int8


@pytest.mark.parametrize("arch", ["glm4_9b", "gemma2_27b", "zamba2_2p7b"])
def test_cuda_graph_equals_eager_under_preemption(arch):
    _card()
    cfg = get_config(arch, smoke=True)
    prompts = _prompts(cfg, 2, 32, 5)
    g, e, eng = _both(arch, prompts, max_new=20, **TIGHT)
    assert eng.stats["preemptions"] >= 1
    assert g == e


def test_cuda_graph_captured_up_front():
    """capture_graphs at start-up: both shapes captured once, every step
    a replay, the same tokens as the lazily captured run."""
    _card()
    cfg = get_config("glm4_9b", smoke=True)
    prompts = _prompts(cfg, 3, 27, 4)
    lazy, _, _ = _both("glm4_9b", prompts, **SMALL)
    eng = InferenceEngine(cfg, device="cuda",
                          params=init_model(cfg, 0, "cuda"), **SMALL)
    eng.capture_graphs()
    eng.capture_graphs()
    assert eng.stats["graph_captures"] == 2
    reqs = [Request(p.copy(), max_new=12, rid=100 + i)
            for i, p in enumerate(prompts)]
    got = eng.run(reqs)
    assert [got[r.rid].tolist() for r in reqs] == lazy
    assert eng.stats["graph_captures"] == 2
    assert sum(eng.stats["graph_replays"].values()) == eng.stats["steps"]


def test_cuda_graph_temperature_replays():
    """Temperature rows are drawn inside the replay (jax's streams): the
    same draws as eager, and the same again in a second graph run."""
    _card()
    cfg = get_config("glm4_9b", smoke=True)
    prompts = _prompts(cfg, 3, 20, 3)
    sp = SamplingParams(temperature=0.8, top_k=20, seed=5)
    g, e, _ = _both("glm4_9b", prompts, max_new=8, sampling=sp, **SMALL)
    g2, _, _ = _both("glm4_9b", prompts, max_new=8, sampling=sp, **SMALL)
    assert g == e == g2


@pytest.mark.parametrize("arch", ["mamba2_370m", "zamba2_2p7b"])
def test_cuda_graph_slot_chunk_invariants(arch):
    """Under replay, a chunk for slot 1 (the slot a device tensor) leaves
    slots 0 and 2 bit-equal, and a fresh chunk gives on a random slot row
    the bits it gives on a zeroed one."""
    _card()
    cfg = get_config(arch, smoke=True)
    eng = InferenceEngine(cfg, device="cuda", max_batch=3, block_size=16,
                          max_len=96, max_num_batched_tokens=3 + 16)
    eng.graphs.capture((True, "greedy"))
    g = torch.Generator(device="cuda").manual_seed(0)

    def randomize():
        for key in ("conv", "ssm"):
            t = eng.cache[key]
            t.copy_(torch.randn(t.shape, generator=g, device="cuda"))

    def chunk(start):
        eng.inputs.reset()
        a = eng.inputs.host
        a["c_tok"][0, :8] = np.arange(1, 9)
        a["c_start"][0], a["c_len"][0], a["c_slot"][0] = start, 8, 1
        if eng.bm is not None:
            a["c_table"][0, :2] = [1, 2]
        eng.inputs.upload()
        logits = eng.graphs.replay((True, "greedy"))["logits"]
        torch.cuda.synchronize()
        return logits[eng.max_batch].clone()

    randomize()
    before = {k: eng.cache[k].clone() for k in ("conv", "ssm")}
    chunk(8)
    for key in ("conv", "ssm"):
        assert torch.equal(eng.cache[key][:, [0, 2]], before[key][:, [0, 2]])
        assert not torch.equal(eng.cache[key][:, 1], before[key][:, 1])
    randomize()
    lg_r = chunk(0)
    state = {k: eng.cache[k][:, 1].clone() for k in ("conv", "ssm")}
    for key in ("conv", "ssm"):
        eng.cache[key][:, 1].zero_()
    assert torch.equal(chunk(0), lg_r)
    for key in ("conv", "ssm"):
        assert torch.equal(eng.cache[key][:, 1], state[key])


MIXED = [SamplingParams(), SamplingParams(temperature=0.8, top_k=20, seed=5),
         SamplingParams(temperature=0.7, top_p=0.9, min_p=0.05,
                        repetition_penalty=1.2, presence_penalty=0.3,
                        frequency_penalty=0.2, logprobs=3, seed=9)]


@pytest.mark.parametrize("arch", ["glm4_9b", "mamba2_370m", "zamba2_2p7b"])
def test_cuda_graph_equals_eager_every_mode(arch):
    """Greedy, temperature and full-pipeline requests arriving apart, so
    steps run in each mode: tokens and logprobs byte-identical, one graph
    per (shape, mode) used."""
    _card()
    cfg = get_config(arch, smoke=True)
    prompts = _prompts(cfg, 3, 27, 6)
    lps = {}
    g, e, eng = _both(arch, prompts, [0, 4, 9], sampling=MIXED,
                      logprobs=lps, **SMALL)
    assert g == e and lps[True] == lps[False]
    modes = {k[1] for k in eng.graphs.graphs}
    assert modes == {"greedy", "plain", "full"}
    assert eng.stats["full_sampling_steps"] > 0


@pytest.mark.parametrize("sampling", [0, 1, 2], ids=["greedy", "plain",
                                                       "full"])
def test_cuda_graph_speculative_equals_eager(sampling):
    """The speculative runner (k = 2, a fresh draft) in each mode: graph
    and eager byte-identical, tokens and logprobs."""
    _card()
    cfg = get_config("glm4_9b", smoke=True)
    prompts = _prompts(cfg, 3, 27, 7)
    lps = {}
    g, e, eng = _both("glm4_9b", prompts, sampling=MIXED[sampling],
                      logprobs=lps, num_speculative_tokens=2, max_batch=2,
                      block_size=16, max_len=96,
                      max_num_batched_tokens=2 * 3 + 12)
    assert g == e and lps[True] == lps[False]
    assert eng.stats["spec_decodes"] > 0

"""The engine's compiled-step contract on the CPU, at smoke size.

On the card the engine captures each runner's step shapes, in each
sampling mode, as CUDA graphs (``repro_torch.serving.graphs``); the CPU
runs the same body eagerly. What makes the body capturable is held here:

* each runner's step body (glm4_9b at prefill_pack 1 and 4, mamba2_370m,
  zamba2_2p7b, and the speculative runner; with and without the chunk
  row; greedy, plain and full sampling), on inputs built by the engine's
  ``_build_arrays``, runs under ``FakeTensorMode``, which raises on any
  read of a tensor's values by the host;
* the step inputs keep their addresses across steps;
* the slot-state chunk, its slot given as a device tensor, writes only
  its own slot row and reads zeros when it is fresh; idle decode slots
  keep their state;
* the null step that warms a capture up changes no cache byte outside
  the trash block, in every mode and in both pool sets of the
  speculative runner;
* ``cuda_graphs=True`` on the CPU raises;
* the replay-aware launch count (launches per capture x replays);
* the temperature draws, made inside the body, give ``sample_tokens``'
  tokens.

The greedy and near-tie comparisons against the JAX engine, and chunked
== monolithic, preempted == uninterrupted and prefix-hit == cold, run on
the same code in ``test_torch_engine.py``, ``test_torch_ssm_engine.py``
and ``test_torch_ragged_prefill.py``. Graph against eager on the card is
``test_torch_engine_graphs_cuda.py``.
"""

from collections import Counter

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.config import get_config
from repro_torch.models.transformer import PAGE_POOLS
from repro_torch.serving import InferenceEngine, Request
from repro_torch.serving import graphs
from repro_torch.serving.kv_cache import TRASH_BLOCK
from repro_torch.serving.runners import SAMPLING_MODES
from repro_torch.serving.sampling import sample_tokens
from repro_torch.serving.scheduler import SamplingParams
import torch_cpu  # noqa: F401  (one torch thread)

# (arch, prefill_pack, kv_dtype, speculative tokens)
RUNNERS = [("glm4_9b", 1, "bf16", 0), ("glm4_9b", 4, "int8", 0),
           ("mamba2_370m", 1, "bf16", 0), ("zamba2_2p7b", 1, "bf16", 0),
           ("glm4_9b", 1, "bf16", 2), ("glm4_9b", 4, "bf16", 2)]
SMALL = dict(max_batch=2, block_size=16, max_len=96,
             max_num_batched_tokens=2 + 16)
# requests whose steps run each sampling mode
MODE_PARAMS = {"greedy": SamplingParams(),
               "plain": SamplingParams(temperature=0.8, top_k=5, seed=1),
               "full": SamplingParams(temperature=0.8, top_p=0.9,
                                      repetition_penalty=1.2, logprobs=2)}


def _engine(arch, pack=1, kv="bf16", spec=0, **kw):
    cfg = get_config(arch, smoke=True)
    budget = {"max_num_batched_tokens": 2 * (1 + spec) + 16}
    return InferenceEngine(cfg, device="cpu", prefill_pack=pack,
                           kv_dtype=kv, num_speculative_tokens=spec,
                           **{**SMALL, **budget, **kw})


def _requests(eng, n=3, length=20, max_new=4, seed=0, sampling=None):
    rng = np.random.default_rng(seed)
    sp = sampling or SamplingParams()
    return [Request(rng.integers(0, eng.cfg.vocab_size, length)
                    .astype(np.int32), max_new=max_new, sampling=sp)
            for _ in range(n)]


def _cache_leaves(eng):
    """(name, tensor) of every cache tensor, the speculative runner's two
    pool sets flattened as "tgt/k", "dft/v", ..."""
    for key, val in eng.cache.items():
        if isinstance(val, dict):
            for name, t in val.items():
                yield f"{key}/{name}", t
        else:
            yield key, val


def _tree(fn, x):
    if isinstance(x, dict):
        return {k: _tree(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tree(fn, v) for v in x)
    return fn(x) if isinstance(x, torch.Tensor) else x


def _random_cache(eng, seed=0):
    """Fill every cache tensor with random values (in place)."""
    g = torch.Generator().manual_seed(seed)
    for _, t in _cache_leaves(eng):
        if t.dtype.is_floating_point and t.element_size() > 1:
            t.copy_(torch.randn(t.shape, generator=g).to(t.dtype))
        else:
            t.view(torch.uint8).copy_(torch.randint(
                0, 256, t.view(torch.uint8).shape, generator=g,
                dtype=torch.uint8))


def _snapshot(eng):
    return {k: v.clone() for k, v in _cache_leaves(eng)}


def _ids(r):
    return "-".join(map(str, r))


def _expected_outputs(eng, mode):
    """{name: (shape, dtype)} of the body's outputs in ``mode``."""
    B, S = eng.max_batch, eng.prefill_pack
    V_pad, L = eng.cfg.padded_vocab_size, eng.runner.max_logprobs
    k = eng.runner.spec_tokens
    f32, i32 = torch.float32, torch.int32
    if eng.draft_cfg is None:
        out = {"logits": ((B + S, V_pad), f32), "tokens": ((B + S,), i32)}
        lp = {"chosen": ((B + S,), f32), "top_lp": ((B + S, L), f32),
              "top_ids": ((B + S, L), i32)}
    else:
        out = {"logits": ((B * (k + 1) + S, V_pad), f32),
               "tokens": ((B, k + 1), i32), "n_acc": ((B,), i32),
               "c_tokens": ((S,), i32)}
        lp = {"chosen": ((B, k + 1), f32), "top_lp": ((B, k + 1, L), f32),
              "top_ids": ((B, k + 1, L), i32), "c_chosen": ((S,), f32),
              "c_top_lp": ((S, L), f32), "c_top_ids": ((S, L), i32)}
    return {**out, **lp} if mode == "full" else out


class _Seen(Exception):
    """Raised once the faked body has run in the wanted shape and mode."""


@pytest.mark.parametrize("mode", SAMPLING_MODES)
@pytest.mark.parametrize("has_chunk", [False, True])
@pytest.mark.parametrize("runner", RUNNERS, ids=_ids)
def test_step_body_reads_no_host_value(runner, has_chunk, mode):
    """The body on the inputs ``_build_arrays`` gave a real step of that
    shape and sampling mode, every tensor fake: a host read of a value
    would raise."""
    arch, pack, kv, spec = runner
    eng = _engine(arch, pack, kv, spec)
    body, seen = eng.runner_body, []
    heads = [n for n in ("head", "draft_head")
             if getattr(eng.runner, n, None) is not None]

    def faked(*, has_chunk, sampling):
        if (has_chunk, sampling) == (want, mode) and not seen:
            fmode = FakeTensorMode()
            fake = lambda t: fmode.from_tensor(t)         # noqa: E731
            fp, fc, fa = (_tree(fake, x) for x in (eng.params, eng.cache,
                                                   eng.inputs.dev))
            real = {n: getattr(eng.runner, n) for n in heads}
            for n in heads:
                setattr(eng.runner, n, fake(real[n]))
            try:
                with fmode:
                    out = eng.runner.step(fp, fc, fa, has_chunk=has_chunk,
                                          sampling=sampling)
            finally:
                for n in heads:
                    setattr(eng.runner, n, real[n])
            seen.append({n: (tuple(t.shape), t.dtype)
                         for n, t in out.items()})
            raise _Seen                    # the rest of the run adds nothing
        return body(has_chunk=has_chunk, sampling=sampling)

    want = has_chunk
    eng.runner_body = faked
    with pytest.raises(_Seen):
        eng.run(_requests(eng, n=3, length=20, max_new=4,
                          sampling=MODE_PARAMS[mode]))
    assert seen == [_expected_outputs(eng, mode)]


@pytest.mark.parametrize("pack", [1, 4])
def test_step_inputs_keep_their_addresses(pack):
    """Every step's body gets the same input tensors at the same
    addresses, whatever the plan."""
    eng = _engine("glm4_9b", pack)
    body, ptrs = eng.runner_body, []

    def recorded(*, has_chunk, sampling):
        ptrs.append({k: (v.data_ptr(), tuple(v.shape))
                     for k, v in body.args[2].items()})
        return body(has_chunk=has_chunk, sampling=sampling)

    eng.runner_body = recorded
    first = {k: (v.data_ptr(), tuple(v.shape))
             for k, v in eng.inputs.dev.items()}
    eng.run(_requests(eng, n=4, length=30, max_new=5))
    assert len(ptrs) == eng.stats["steps"] > 4
    assert all(p == first for p in ptrs)
    assert eng.graphs is None and eng.stats["graph_captures"] == 0


def _slot_chunk(eng, slot, start, n, seed=1):
    """Fill the inputs with one chunk of n tokens at position ``start``
    for ``slot`` (no decode active) and run the body with the chunk."""
    rng = np.random.default_rng(seed)
    eng.inputs.reset()
    a = eng.inputs.host
    a["c_tok"][0, :n] = rng.integers(0, eng.cfg.vocab_size, n)
    a["c_start"][0], a["c_len"][0], a["c_slot"][0] = start, n, slot
    if eng.bm is not None:                    # blocks 1.. cover the chunk
        nb = -(-(start + n) // eng.block_size)
        a["c_table"][0, :nb] = np.arange(1, nb + 1)
    eng.inputs.upload()
    with torch.no_grad():
        return eng.runner_body(has_chunk=True)["logits"]


@pytest.mark.parametrize("arch", ["mamba2_370m", "zamba2_2p7b"])
def test_slot_chunk_on_device_index(arch):
    """A chunk for slot 1 changes slot 1's state rows only (slot 0's and
    the idle decode slots' are bit-equal), and a fresh chunk (c_start 0)
    reads zeros: on a random slot row it gives the bits it gives on a
    zeroed one."""
    eng = _engine(arch, max_batch=3)
    _random_cache(eng)
    before = _snapshot(eng)
    _slot_chunk(eng, slot=1, start=8, n=8)
    for key in ("conv", "ssm"):
        for s in (0, 2):
            assert torch.equal(eng.cache[key][:, s], before[key][:, s])
        assert not torch.equal(eng.cache[key][:, 1], before[key][:, 1])

    _random_cache(eng, seed=2)
    logits_r = _slot_chunk(eng, slot=1, start=0, n=8)
    got = {k: eng.cache[k][:, 1].clone() for k in ("conv", "ssm")}
    others = {k: eng.cache[k][:, [0, 2]].clone() for k in ("conv", "ssm")}
    for key in ("conv", "ssm"):
        eng.cache[key][:, 1].zero_()
    logits_z = _slot_chunk(eng, slot=1, start=0, n=8)
    B = eng.max_batch
    assert torch.equal(logits_r[B], logits_z[B])
    for key in ("conv", "ssm"):
        assert torch.equal(eng.cache[key][:, 1], got[key])
        assert torch.equal(eng.cache[key][:, [0, 2]], others[key])


@pytest.mark.parametrize("runner", RUNNERS, ids=_ids)
def test_null_step_changes_only_the_trash_block(runner):
    """The capture's warm-up step, in both shapes and every sampling mode,
    on random caches: every slot-state row and every page but the trash
    block (of both pool sets, for the speculative runner) keep their
    bits."""
    arch, pack, kv, spec = runner
    eng = _engine(arch, pack, kv, spec)
    eng._full_inputs()                  # the full mode's input area
    _random_cache(eng)
    before = _snapshot(eng)
    for has_chunk in (False, True):
        for mode in SAMPLING_MODES:
            eng.inputs.null_step()
            with torch.no_grad():
                eng.runner_body(has_chunk=has_chunk, sampling=mode)
    for key, t in _cache_leaves(eng):
        if key.split("/")[-1] in PAGE_POOLS:
            keep = [b for b in range(t.shape[1]) if b != TRASH_BLOCK]
            t, ref = t[:, keep], before[key][:, keep]
        else:
            ref = before[key]
        assert torch.equal(t.view(torch.uint8), ref.view(torch.uint8)), key


def test_cuda_graphs_need_a_card():
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        _engine("glm4_9b", cuda_graphs=True)
    eng = _engine("glm4_9b", cuda_graphs=None)
    eng.capture_graphs()                  # nothing to capture on the CPU
    assert eng.graphs is None and eng.stats["graph_captures"] == 0
    assert _engine("glm4_9b", cuda_graphs=False).graphs is None


def test_replayed_launch_counts():
    """Launches per capture x replays, per shape, summed by kernel; a
    shape captured but never replayed adds nothing."""
    per_capture = {False: Counter({("paged_attention", "bf16"): 2,
                                   ("gather", ""): 1}),
                   True: Counter({("paged_attention", "bf16"): 2,
                                  ("paged_prefill_attention", "bf16"): 2,
                                  ("gather", ""): 2, ("ssd", ""): 3})}
    got = graphs.replayed_launches(per_capture, {False: 10, True: 4})
    assert got == {("paged_attention", "bf16"): 28,
                   ("paged_prefill_attention", "bf16"): 8,
                   ("gather", ""): 18, ("ssd", ""): 12}
    assert graphs.replayed_launches(per_capture, {False: 3}) == {
        ("paged_attention", "bf16"): 6, ("gather", ""): 3}
    assert graphs.replayed_launches(per_capture, {}) == {}


def test_launch_counts_read_every_wrapper(monkeypatch):
    """launch_counts reads every kernel wrapper's counter: by variant for
    the Counters, under "" for the plain ints; a capture's launches are
    the difference of two readings."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ssd as ssd_k
    for fn in graphs.KERNELS:
        monkeypatch.setattr(fn, "launches", Counter() if isinstance(
            fn.launches, dict) else 0)
    before = graphs.launch_counts()
    assert sum(before.values()) == 0
    pa.paged_attention.launches.update({"bf16": 3, "int8": 1})
    ssd_k.ssd.launches += 5
    assert graphs.launch_counts() - before == {
        ("paged_attention", "bf16"): 3, ("paged_attention", "int8"): 1,
        ("ssd", ""): 5}
    assert len(graphs.KERNELS) == 7


def test_draws_after_the_body_equal_sample_tokens():
    """The draw now happens inside the body: in a real engine run with
    greedy and temperature rows, every plain-mode body's tokens equal
    ``sample_tokens`` on its own logits and sampling inputs, and its
    greedy rows the argmax."""
    eng = _engine("glm4_9b", max_batch=3)
    body, checked = eng.runner_body, []

    def recorded(*, has_chunk, sampling):
        out = body(has_chunk=has_chunk, sampling=sampling)
        if sampling == "plain":
            a = eng.inputs.dev
            want = sample_tokens(out["logits"], a["temps"], a["top_ks"],
                                 a["seeds"], a["rids"], a["counters"])
            assert torch.equal(out["tokens"], want)
            greedy = a["temps"] <= 0
            assert torch.equal(out["tokens"][greedy],
                               out["logits"][greedy].argmax(-1).int())
            checked.append(bool((~greedy).any()))
        return out

    eng.runner_body = recorded
    reqs = _requests(eng, n=4, length=20, max_new=5)
    for i in (1, 2):
        reqs[i].sampling = SamplingParams(temperature=0.5 + i / 4,
                                          top_k=4 * i, seed=i)
    eng.run(reqs)
    assert len(checked) >= 5 and all(checked)

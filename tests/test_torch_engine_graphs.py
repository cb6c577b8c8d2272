"""The engine's compiled-step contract on the CPU, at smoke size.

On the card the engine captures each runner's two step shapes as CUDA
graphs (``repro_torch.serving.graphs``); the CPU runs the same body
eagerly. What makes the body capturable is held here:

* each runner's step body (glm4_9b at prefill_pack 1 and 4, mamba2_370m,
  zamba2_2p7b; with and without the chunk row), on inputs built by the
  engine's ``_build_arrays``, runs under ``FakeTensorMode``, which raises
  on any read of a tensor's values by the host;
* the step inputs keep their addresses across steps;
* the slot-state chunk, its slot given as a device tensor, writes only
  its own slot row and reads zeros when it is fresh; idle decode slots
  keep their state;
* the null step that warms a capture up changes no cache byte outside
  the trash block;
* ``cuda_graphs=True`` on the CPU raises;
* the replay-aware launch count (launches per capture x replays);
* the temperature draws, now after the body, give ``sample_tokens``'
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
from repro_torch.serving.sampling import draw_rows, sample_tokens

# (arch, prefill_pack, kv_dtype)
RUNNERS = [("glm4_9b", 1, "bf16"), ("glm4_9b", 4, "int8"),
           ("mamba2_370m", 1, "bf16"), ("zamba2_2p7b", 1, "bf16")]
SMALL = dict(max_batch=2, block_size=16, max_len=96,
             max_num_batched_tokens=2 + 16)


def _engine(arch, pack=1, kv="bf16", **kw):
    cfg = get_config(arch, smoke=True)
    return InferenceEngine(cfg, device="cpu", prefill_pack=pack,
                           kv_dtype=kv, **{**SMALL, **kw})


def _requests(eng, n=3, length=20, max_new=4, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(rng.integers(0, eng.cfg.vocab_size, length)
                    .astype(np.int32), max_new=max_new) for _ in range(n)]


def _tree(fn, x):
    if isinstance(x, dict):
        return {k: _tree(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tree(fn, v) for v in x)
    return fn(x) if isinstance(x, torch.Tensor) else x


def _random_cache(eng, seed=0):
    """Fill every cache tensor with random values (in place)."""
    g = torch.Generator().manual_seed(seed)
    for t in eng.cache.values():
        if t.dtype.is_floating_point and t.element_size() > 1:
            t.copy_(torch.randn(t.shape, generator=g).to(t.dtype))
        else:
            t.view(torch.uint8).copy_(torch.randint(
                0, 256, t.view(torch.uint8).shape, generator=g,
                dtype=torch.uint8))


def _snapshot(eng):
    return {k: v.clone() for k, v in eng.cache.items()}


@pytest.mark.parametrize("has_chunk", [False, True])
@pytest.mark.parametrize("runner", RUNNERS, ids=lambda r: "-".join(map(
    str, r)))
def test_step_body_reads_no_host_value(runner, has_chunk):
    """The body on the inputs ``_build_arrays`` gave a real step of that
    shape, every tensor fake: a host read of a value would raise."""
    arch, pack, kv = runner
    eng = _engine(arch, pack, kv)
    body, seen = eng.runner_body, []

    def faked(*, has_chunk):
        if has_chunk == want and not seen:
            mode = FakeTensorMode()
            fake = lambda t: mode.from_tensor(t)          # noqa: E731
            fp, fc, fa = (_tree(fake, x) for x in (eng.params, eng.cache,
                                                   eng.inputs.dev))
            head, eng.runner.head = eng.runner.head, fake(eng.runner.head)
            try:
                with mode:
                    logits, toks = eng.runner.step(fp, fc, fa,
                                                   has_chunk=has_chunk)
            finally:
                eng.runner.head = head
            seen.append((tuple(logits.shape), logits.dtype,
                         tuple(toks.shape), toks.dtype))
        return body(has_chunk=has_chunk)

    want = has_chunk
    eng.runner_body = faked
    eng.run(_requests(eng, n=3, length=20, max_new=4))
    rows = eng.max_batch + eng.prefill_pack
    V_pad = eng.runner.head.shape[0]
    assert seen == [((rows, V_pad), torch.float32, (rows,), torch.int32)]


@pytest.mark.parametrize("pack", [1, 4])
def test_step_inputs_keep_their_addresses(pack):
    """Every step's body gets the same input tensors at the same
    addresses, whatever the plan."""
    eng = _engine("glm4_9b", pack)
    body, ptrs = eng.runner_body, []

    def recorded(*, has_chunk):
        ptrs.append({k: (v.data_ptr(), tuple(v.shape))
                     for k, v in body.args[2].items()})
        return body(has_chunk=has_chunk)

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
        return eng.runner_body(has_chunk=True)


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
    logits_r, _ = _slot_chunk(eng, slot=1, start=0, n=8)
    got = {k: eng.cache[k][:, 1].clone() for k in ("conv", "ssm")}
    others = {k: eng.cache[k][:, [0, 2]].clone() for k in ("conv", "ssm")}
    for key in ("conv", "ssm"):
        eng.cache[key][:, 1].zero_()
    logits_z, _ = _slot_chunk(eng, slot=1, start=0, n=8)
    B = eng.max_batch
    assert torch.equal(logits_r[B], logits_z[B])
    for key in ("conv", "ssm"):
        assert torch.equal(eng.cache[key][:, 1], got[key])
        assert torch.equal(eng.cache[key][:, [0, 2]], others[key])


@pytest.mark.parametrize("runner", RUNNERS, ids=lambda r: "-".join(map(
    str, r)))
def test_null_step_changes_only_the_trash_block(runner):
    """The capture's warm-up step, in both shapes, on random caches: every
    slot-state row and every page but the trash block keep their bits."""
    arch, pack, kv = runner
    eng = _engine(arch, pack, kv)
    _random_cache(eng)
    before = _snapshot(eng)
    for has_chunk in (False, True):
        eng.inputs.null_step()
        with torch.no_grad():
            eng.runner_body(has_chunk=has_chunk)
    for key, t in eng.cache.items():
        if key in PAGE_POOLS:
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
    """The engine's order (greedy argmax in the body, temperature rows
    drawn after it) gives sample_tokens' tokens; greedy rows keep their
    argmax."""
    rng = np.random.default_rng(3)
    logits = torch.tensor(rng.normal(0, 3, (6, 50)), dtype=torch.float32)
    temps = np.array([0, 0.7, 0, 1.3, 0.2, 0], np.float32)
    top_ks = np.array([0, 5, 0, 0, 3, 0], np.int32)
    seeds, rids = np.arange(6) + 10, np.arange(6) + 100
    counters = np.array([0, 3, 1, 7, 2, 0])
    want = sample_tokens(logits, temps, top_ks, seeds, rids, counters)
    toks = torch.argmax(logits, dim=-1).to(torch.int32)
    greedy = toks.clone()
    draw_rows(logits, toks, temps, top_ks, seeds, rids, counters)
    assert torch.equal(toks, want)
    assert torch.equal(toks[temps == 0], greedy[temps == 0])

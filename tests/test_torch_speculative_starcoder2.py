"""The JAX package's speculative-decoding engine tests on starcoder2_3b
(``tests/test_serving.py``, "Speculative decoding"), held on the port at
smoke size on the CPU: greedy speculation equals plain greedy with a
self-draft sharing the weights and with a fresh draft; over int8 pools;
with full-prompt prefix hits and a boundary copy-on-write; under
recompute-preemption (the lookahead rolled back, no block leaked);
temperature speculation replays across preemption; k = 0 is the plain
engine, temperature stream included; and the pairs the reference refuses
are refused.

Where the reference asserts byte equality between a speculative and a
plain run, the port asserts it up to a near-tie: the verify pass's GEMMs
take k + 1 rows a sequence where decode takes one, and the CPU rounds a
GEMM row by its position (``test_torch_speculative.py``); the near-tie
is judged on the plain engine's logits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.config import get_config as jax_get_config
from repro.models import api as japi
from repro_torch.config import get_config
from repro_torch.models.api import params_from_jax
from repro_torch.serving import InferenceEngine, Request, SamplingParams
from repro_torch.serving.runners import SpeculativeRunner, make_runner
from test_torch_engine import _assert_same_or_near_tie
import torch_cpu  # noqa: F401  (one torch thread)


@pytest.fixture(scope="module")
def star():
    """starcoder2's smoke config and the reference's seed-0 weights in
    bf16, converted."""
    jcfg = jax_get_config("starcoder2_3b", smoke=True)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    with jax.set_mesh(mesh):
        pf, _ = japi.init_model(jcfg, jax.random.key(0))
        tree = jax.tree.map(lambda x: np.asarray(x.astype(jnp.bfloat16)), pf)
    cfg = get_config("starcoder2_3b", smoke=True)
    return cfg, params_from_jax(tree, cfg, "cpu")


def _plain(star, **kw):
    cfg, params = star
    return InferenceEngine(cfg, device="cpu", params=params,
                           debug_invariants=True,
                           **{**dict(max_batch=2, block_size=16, max_len=96),
                              **kw})


def _spec(star, k, *, self_draft=False, **kw):
    cfg, params = star
    return _plain(star, num_speculative_tokens=k,
                  draft_params=params if self_draft else None, **kw)


def _prompts(n, length=32):
    rng = np.random.default_rng(length)
    return [rng.integers(0, 256, length).astype(np.int32) for _ in range(n)]


@pytest.mark.parametrize("self_draft", [True, False])
def test_speculative_greedy_matches_plain(star, self_draft):
    prompts = _prompts(4)
    plain = _plain(star)
    pr = [Request(p, max_new=8) for p in prompts]
    want = plain.run(pr)
    spec = _spec(star, 2, self_draft=self_draft)
    assert isinstance(spec.runner, SpeculativeRunner)
    reqs = [Request(p, max_new=8) for p in prompts]
    got = spec.run(reqs, arrival_steps=[0, 0, 2, 5])
    for p, a, r in zip(prompts, pr, reqs):
        _assert_same_or_near_tie(plain, p, got[r.rid].tolist(),
                                 want[a.rid].tolist())
    assert spec.stats["spec_decodes"] >= 1
    if self_draft:
        assert spec.mean_accept_len > 1.0


def test_int8_speculative_matches_plain_int8(star):
    prompts = _prompts(4)
    plain = _plain(star, kv_dtype="int8")
    pr = [Request(p, max_new=8) for p in prompts]
    want = plain.run(pr)
    spec = _spec(star, 2, self_draft=True, kv_dtype="int8")
    reqs = [Request(p, max_new=8) for p in prompts]
    got = spec.run(reqs, arrival_steps=[0, 0, 2, 5])
    for p, a, r in zip(prompts, pr, reqs):
        _assert_same_or_near_tie(plain, p, got[r.rid].tolist(),
                                 want[a.rid].tolist())
    assert spec.mean_accept_len > 1.0


def test_speculative_prefix_cache_hit_cow(star):
    prompt = _prompts(1, 64)[0]
    kw = dict(max_batch=4)
    plain = _plain(star, **kw)
    reqs_p = [Request(prompt.copy(), max_new=6) for _ in range(3)]
    o_p = plain.run(reqs_p, arrival_steps=[0, 3, 6])
    spec = _spec(star, 2, self_draft=True, **kw)
    reqs_s = [Request(prompt.copy(), max_new=6) for _ in range(3)]
    o_s = spec.run(reqs_s, arrival_steps=[0, 3, 6])
    assert spec.stats["cow_copies"] >= 1
    assert spec.stats["cache_hit_tokens"] >= 2 * 63
    assert spec.mean_accept_len > 1.0
    for a, b in zip(reqs_p, reqs_s):
        _assert_same_or_near_tie(plain, prompt, o_s[b.rid].tolist(),
                                 o_p[a.rid].tolist())


def test_speculative_preemption_greedy(star):
    prompts = _prompts(2)
    plain = _plain(star)
    pr = [Request(p, max_new=20) for p in prompts]
    want = plain.run(pr)
    tight = _spec(star, 2, num_blocks=8)
    reqs = [Request(p, max_new=20) for p in prompts]
    got = tight.run(reqs)
    assert tight.stats["preemptions"] >= 1
    for p, a, r in zip(prompts, pr, reqs):
        _assert_same_or_near_tie(plain, p, got[r.rid].tolist(),
                                 want[a.rid].tolist())
    assert tight.bm.stats().blocks_in_use == 0


def test_speculative_temperature_replays_across_preemption(star):
    prompts = _prompts(2)
    sp = SamplingParams(temperature=0.9, top_k=16, seed=3)

    def make():
        return [Request(p, max_new=20, sampling=sp, rid=88000 + i)
                for i, p in enumerate(prompts)]

    base = _spec(star, 2)
    want = base.run(make())
    tight = _spec(star, 2, num_blocks=8)
    reqs = make()
    got = tight.run(reqs)
    assert tight.stats["preemptions"] >= 1
    for r in reqs:
        np.testing.assert_array_equal(got[r.rid], want[r.rid])


def test_speculative_k0_degenerates_to_plain(star):
    cfg, _ = star
    prompts = _prompts(2)
    sp = SamplingParams(temperature=0.9, top_k=16, seed=7)

    def make():
        return [Request(p, max_new=10, sampling=sp, rid=99000 + i)
                for i, p in enumerate(prompts)]

    want = _plain(star).run(make())
    k0 = _spec(star, 0, draft_cfg=cfg)
    assert isinstance(k0.runner, SpeculativeRunner)
    got = k0.run(make())
    for rid, w in want.items():
        np.testing.assert_array_equal(got[rid], w)


def test_speculative_runner_rejects_bad_pairs():
    star = get_config("starcoder2_3b", smoke=True)
    mamba = get_config("mamba2_370m", smoke=True)
    with pytest.raises(ValueError, match="paged-transformer"):
        make_runner(mamba, draft_cfg=star, num_speculative_tokens=2)
    with pytest.raises(ValueError, match="paged-transformer"):
        make_runner(star, draft_cfg=mamba, num_speculative_tokens=2)
    # full-size configs: smoke vocabs all coincide at 256
    with pytest.raises(ValueError, match="vocab"):
        make_runner(get_config("starcoder2_3b"),
                    draft_cfg=get_config("glm4_9b"),
                    num_speculative_tokens=2)

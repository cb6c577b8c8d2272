"""The port's engine on qwen3_32b, starcoder2_3b and gemma2_27b at smoke
size on the CPU.

Against the JAX engine: the same bf16 parameters and requests give the
same greedy tokens through prefix hits with a boundary copy-on-write,
preemption-recompute and chunked prefill (gemma2's prompts run past its
16-token window). Against the port's own static path (the JAX package's
``StaticServerOracle`` invariant): equal-length prompts served by the
engine give ``api.generate_static``'s greedy tokens, for every dense
arch. A token may differ only after a first difference whose top-2 logit
margin is below the bf16 tolerance, as in ``test_torch_engine.py``."""

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
from repro_torch.models import api
from repro_torch.models.api import params_from_jax
from repro_torch.serving import InferenceEngine, Request
from test_torch_engine import _assert_same_or_near_tie
import torch_cpu  # noqa: F401  (one torch thread)

# max_batch 2, 16-token blocks, 12-token chunks; 7 allocatable blocks
# force preemption once two requests pass 3 blocks each
TIGHT = dict(max_batch=2, block_size=16, max_len=96, num_blocks=8,
             max_num_batched_tokens=2 + 12)


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _setup(mesh, arch):
    cfg = jax_get_config(arch, smoke=True)
    with jax.set_mesh(mesh):
        pf, _ = japi.init_model(cfg, jax.random.key(0))
        tree = jax.tree.map(lambda x: np.asarray(x.astype(jnp.bfloat16)), pf)
    tcfg = get_config(arch, smoke=True)
    return cfg, tree, tcfg, params_from_jax(tree, tcfg, "cpu")


@pytest.mark.parametrize("arch", ["qwen3_32b", "starcoder2_3b",
                                  "gemma2_27b"])
def test_engine_greedy_matches_reference(mesh, arch):
    cfg, tree, tcfg, params = _setup(mesh, arch)
    rng = np.random.default_rng(11)
    prefix = rng.integers(0, cfg.vocab_size, 32).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 8)
                               .astype(np.int32)]),
               prefix.copy(),                # two full cached blocks: COW
               np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 13)
                               .astype(np.int32)]),
               rng.integers(0, cfg.vocab_size, 20).astype(np.int32)]
    arrivals = [0, 5, 9, 9]
    jeng = JaxEngine(cfg, mesh, params=jax.tree.map(jnp.asarray, tree),
                     debug_invariants=True, **TIGHT)
    jreqs = [JaxRequest(p.copy(), max_new=20) for p in prompts]
    jouts = jeng.run(jreqs, arrival_steps=arrivals)
    eng = InferenceEngine(tcfg, device="cpu", params=params,
                          debug_invariants=True, **TIGHT)
    reqs = [Request(p.copy(), max_new=20) for p in prompts]
    outs = eng.run(reqs, arrival_steps=arrivals)
    s = eng.stats
    assert s["preemptions"] >= 1 and s["cow_copies"] >= 1
    assert s["cache_hit_tokens"] > 0 and s["prefill_chunks"] > len(prompts)
    for p, r, jr in zip(prompts, reqs, jreqs):
        ours = outs[r.rid].tolist()
        assert len(ours) == 20 and all(0 <= t < cfg.vocab_size for t in ours)
        _assert_same_or_near_tie(eng, p, ours, jouts[jr.rid].tolist())


@pytest.mark.parametrize("arch", ["glm4_9b", "qwen3_32b", "starcoder2_3b",
                                  "gemma2_27b"])
def test_engine_matches_static_path(mesh, arch):
    """Four 24-token prompts, 12 new tokens each: the engine (16-token
    chunks, so two chunks a prompt) gives ``generate_static``'s tokens."""
    _, _, tcfg, params = _setup(mesh, arch)
    rng = np.random.default_rng(13)
    toks = rng.integers(0, tcfg.vocab_size, (4, 24)).astype(np.int32)
    want = api.generate_static(params, torch.from_numpy(toks), tcfg, 12)
    eng = InferenceEngine(tcfg, device="cpu", params=params, max_batch=4,
                          block_size=8, max_len=48,
                          max_num_batched_tokens=4 + 16,
                          debug_invariants=True)
    reqs = [Request(t.copy(), max_new=12) for t in toks]
    outs = eng.run(reqs)
    assert eng.stats["prefill_chunks"] == 2 * len(reqs)
    for t, r, w in zip(toks, reqs, want):
        _assert_same_or_near_tie(eng, t, outs[r.rid].tolist(), w.tolist())


def test_serve_cli_runs_each_arch(capsys):
    from repro_torch.launch import serve
    for arch in ("qwen3_32b", "starcoder2_3b", "gemma2_27b"):
        serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                    "--requests", "2", "--max-new", "3", "--prompt-len",
                    "20"])
        out = capsys.readouterr().out
        assert f"arch={get_config(arch, smoke=True).name}" in out
        assert "runner=TransformerRunner" in out
        assert "[serve] sample output ids:" in out

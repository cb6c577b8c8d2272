"""The port's encoder-decoder (whisper at smoke size) on the CPU.

Against the JAX package (``repro.models.encdec``): ``encode`` and
``encode_cross_kv`` in fp32 at 1e-5 of each output's largest value; the
static ``prefill`` / ``decode_step`` in fp32 (caches at 1e-5, the same
greedy tokens); the engine's pair ``prefill_chunk_paged`` /
``decode_step_paged`` in bf16 against the JAX functions on the same page
pools and cross K/V (logits and written pages at the bf16 tolerance);
the port's engine against the JAX engine (the same plans, greedy tokens
up to a near-tie of the port's own logits, ``test_torch_moe_engine``'s
rule).

The port's versions of ``test_engine_matches_static_whisper`` and
``test_engine_whisper_preemption_reencodes`` (``tests/test_serving.py``):
distinct frames per request, the engine's tokens equal the static path's
(up to a near-tie), and a preempted request is encoded again on its
return and gives the uninterrupted run's tokens. The reference's
refusals: no host swap tier, no shared prefix index, bf16 pools only;
prefix caching and packed prefill are off."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ParallelConfig as JPar
from repro.config import get_config as jax_get_config
from repro.models import api as japi
from repro.models import encdec as jencdec
from repro.serving import InferenceEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.config import get_config
from repro_torch.models import api, encdec
from repro_torch.models.api import params_from_jax
from repro_torch.serving import InferenceEngine, Request
from repro_torch.serving.cache import encoder_cache_bytes
from repro_torch.serving.runners import EncDecRunner, make_runner
from test_torch_moe_engine import assert_same_or_near_tie, record
import torch_cpu  # noqa: F401  (one torch thread)

ARCH = "whisper_large_v3"
FP32_TOL = 1e-5
BF16_TOL = 1e-2
PCFG = JPar(remat="none")


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _setup(mesh, dtype="bfloat16"):
    """(JAX cfg, JAX tree in ``dtype``, port cfg, port params)."""
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True),
                               dtype=dtype)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    with jax.set_mesh(mesh):
        pf, _ = japi.init_model(jcfg, jax.random.key(0))
        tree = jax.tree.map(lambda x: np.asarray(x.astype(jdt)), pf)
    return jcfg, tree, tcfg, params_from_jax(tree, tcfg, "cpu")


def _close(ours, ref, tol):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(ours, np.float32), ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-6))


def _frames(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1, (n, cfg.encoder_seq_len, cfg.d_model)).astype(
        np.float32)


def test_encode_and_cross_kv_match_reference(mesh):
    jcfg, tree, tcfg, params = _setup(mesh, "float32")
    frames = _frames(tcfg, 2)
    with jax.set_mesh(mesh):
        jp = jax.tree.map(jnp.asarray, tree)
        enc = jencdec.encode(jp, jnp.asarray(frames), jcfg, PCFG)
        kv = jencdec.encode_cross_kv(jp, jnp.asarray(frames), jcfg, PCFG)
    ft = torch.from_numpy(frames)
    _close(encdec.encode(params, ft, tcfg).numpy(), enc, FP32_TOL)
    ours = encdec.encode_cross_kv(params, ft, tcfg)
    for n in ("xk", "xv"):
        assert ours[n].shape == (tcfg.num_layers, 2, tcfg.encoder_seq_len,
                                 tcfg.num_kv_heads, tcfg.head_dim)
        _close(ours[n].numpy(), kv[n], FP32_TOL)


def test_static_path_matches_reference(mesh):
    """fp32: the prefill's caches and next token, then four decode steps'
    tokens, through ``api.prefill_fn`` / ``decode_fn``; and
    ``generate_static`` gives the same tokens."""
    jcfg, tree, tcfg, params = _setup(mesh, "float32")
    B, S, N = 2, 8, 4
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    frames = _frames(tcfg, B, 2)
    with jax.set_mesh(mesh):
        jp = jax.tree.map(jnp.asarray, tree)
        jc, jt = japi.prefill_fn(jp, {"tokens": jnp.asarray(toks),
                                      "frames": jnp.asarray(frames)},
                                 jcfg, PCFG)
        kv0 = jc
        jc = {n: (jnp.pad(x, ((0, 0), (0, 0), (0, N), (0, 0), (0, 0)))
                  if n in ("k", "v") else x) for n, x in jc.items()}
        want = [np.asarray(jt)]
        for i in range(N):
            jt, jc = japi.decode_fn(jp, jc, {"token": jt[:, None],
                                             "pos": jnp.full((B,), S + i,
                                                             jnp.int32)},
                                    jcfg, PCFG)
            want.append(np.asarray(jt))
    batch = {"tokens": torch.from_numpy(toks),
             "frames": torch.from_numpy(frames)}
    cache, tok = api.prefill_fn(params, batch, tcfg, max_len=S + N)
    for n in ("k", "v", "xk", "xv"):
        ours = cache[n][:, :, :S] if n in ("k", "v") else cache[n]
        _close(ours.numpy(), kv0[n], FP32_TOL)
    got = [tok.numpy()]
    for i in range(N):
        tok, cache = api.decode_fn(params, cache, {
            "token": tok[:, None],
            "pos": torch.full((B,), S + i, dtype=torch.int32)}, tcfg)
        got.append(tok.numpy())
    np.testing.assert_array_equal(np.stack(got, 1), np.stack(want, 1))
    out = api.generate_static(params, torch.from_numpy(toks), tcfg, N + 1,
                              frames=torch.from_numpy(frames))
    np.testing.assert_array_equal(out.numpy(), np.stack(want, 1))


def test_paged_pair_matches_reference(mesh):
    """bf16: a 10-row chunk (2 padding rows) then a decode step for two
    sequences, each against its own cross K/V, on the same pools in both
    packages: logits and written pages at the bf16 tolerance."""
    jcfg, tree, tcfg, params = _setup(mesh)
    L, K, hd, Te = (tcfg.num_layers, tcfg.num_kv_heads, tcfg.head_dim,
                    tcfg.encoder_seq_len)
    NB, bs, B, C = 6, 8, 2, 10
    frames = _frames(tcfg, B, 3)
    with jax.set_mesh(mesh):
        jp = jax.tree.map(jnp.asarray, tree)
        cross = jencdec.encode_cross_kv(
            jp, jnp.asarray(frames, jnp.bfloat16), jcfg, PCFG)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, tcfg.vocab_size, (B, C)).astype(np.int32)
    q_lens = np.array([10, 8], np.int32)
    bt = np.array([[1, 2], [3, 4]], np.int32)
    chunk = {"tokens": toks, "q_start": np.zeros(B, np.int32),
             "q_lens": q_lens, "block_tables": bt, "ctx_lens": q_lens}
    dec = {"token": rng.integers(0, tcfg.vocab_size, (B, 1)).astype(
        np.int32), "pos": q_lens.copy(), "block_tables": bt,
        "ctx_lens": q_lens + 1}
    zeros = np.zeros((L, NB, bs, K, hd), np.float32)
    with jax.set_mesh(mesh):
        jcache = {"self": {"k": jnp.asarray(zeros, jnp.bfloat16),
                           "v": jnp.asarray(zeros, jnp.bfloat16)},
                  "cross": cross}
        jl1, jcache = jencdec.prefill_chunk_paged(
            jp, jcache, {k: jnp.asarray(v) for k, v in chunk.items()},
            jcfg, PCFG)
        jl2, jcache = jencdec.decode_step_paged(
            jp, jcache, {k: jnp.asarray(v) for k, v in dec.items()}, jcfg,
            PCFG)
    tcache = {"self": {n: torch.zeros((L, NB, bs, K, hd),
                                      dtype=torch.bfloat16)
                       for n in ("k", "v")},
              "cross": encdec.encode_cross_kv(
                  params, torch.from_numpy(frames).bfloat16(), tcfg)}
    for n in ("xk", "xv"):
        assert tcache["cross"][n].shape == (L, B, Te, K, hd)
        _close(tcache["cross"][n].float().numpy(), cross[n], BF16_TOL)
    tl1, _ = encdec.prefill_chunk_paged(
        params, tcache, {k: torch.from_numpy(v) for k, v in chunk.items()},
        tcfg)
    tl2, _ = encdec.decode_step_paged(
        params, tcache, {k: torch.from_numpy(v) for k, v in dec.items()},
        tcfg)
    V = tcfg.vocab_size
    _close(tl1[:, :V].numpy(), np.asarray(jl1)[:, :V], 5 * BF16_TOL)
    _close(tl2[:, :V].numpy(), np.asarray(jl2)[:, :V], 5 * BF16_TOL)
    for n in ("k", "v"):
        _close(tcache["self"][n].float().numpy(), jcache["self"][n],
               5 * BF16_TOL)


def _engine_pair(mesh, prompts, frames, max_new, arrivals=None, **kw):
    """The JAX engine's and the port's (with its record) on the same bf16
    weights and requests."""
    jcfg, tree, tcfg, params = _setup(mesh)
    jeng = JaxEngine(jcfg, mesh, params=jax.tree.map(jnp.asarray, tree),
                     debug_invariants=True, **kw)
    jreqs = [JaxRequest(p.copy(), max_new=max_new, frames=f)
             for p, f in zip(prompts, frames)]
    jouts = jeng.run(jreqs, arrival_steps=arrivals)
    eng = InferenceEngine(tcfg, device="cpu", params=params,
                          debug_invariants=True, **kw)
    log = record(eng)
    reqs = [Request(p.copy(), max_new=max_new, frames=f)
            for p, f in zip(prompts, frames)]
    outs = eng.run(reqs, arrival_steps=arrivals)
    return (jeng, [jouts[r.rid].tolist() for r in jreqs]), \
        (eng, [outs[r.rid].tolist() for r in reqs], [log[r.rid]
                                                     for r in reqs])


def test_engine_matches_static_whisper(mesh):
    """Three 8-token prompts with distinct frames, 6 new tokens, arriving
    at steps 0, 1 and 4: three encodes; the tokens equal the static
    path's (one request a batch, each with its frames) up to a near-tie,
    and the JAX engine's the same way."""
    tcfg = get_config(ARCH, smoke=True)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tcfg.vocab_size, 8).astype(np.int32)
               for _ in range(3)]
    frames = list(_frames(tcfg, 3, 6))
    (jeng, jouts), (eng, outs, logs) = _engine_pair(
        mesh, prompts, frames, 6, [0, 1, 4], max_batch=2, block_size=16,
        max_len=64)
    assert eng.encoder_cache is not None and eng.stats["encodes"] == 3
    assert jeng.stats["encodes"] == 3
    for key in ("steps", "prefill_chunks", "tokens"):
        assert eng.stats[key] == jeng.stats[key], key
    params = eng.params
    for p, f, ours, j, log in zip(prompts, frames, outs, jouts, logs):
        want = api.generate_static(
            params, torch.from_numpy(p[None]), tcfg, 6,
            frames=torch.from_numpy(f[None])).numpy()[0].tolist()
        assert_same_or_near_tie(ours, want, log)
        assert_same_or_near_tie(ours, j, log)


def test_engine_whisper_preemption_reencodes(mesh):
    """A victim of block-pool preemption runs its encode pass again on
    readmission, and the greedy tokens equal the uninterrupted run's."""
    tcfg = get_config(ARCH, smoke=True)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, tcfg.vocab_size, 32).astype(np.int32)
               for _ in range(2)]
    frames = list(_frames(tcfg, 2, 9))
    kw = dict(max_batch=2, block_size=16, max_len=96)
    (jeng, jouts), (tight, got, logs) = _engine_pair(
        mesh, prompts, frames, 20, num_blocks=8, **kw)
    assert tight.stats["preemptions"] >= 1
    # one encode per admission: 2, and one per readmission
    assert tight.stats["encodes"] >= 2 + tight.stats["preemptions"]
    assert tight.stats["encodes"] == jeng.stats["encodes"]
    base = InferenceEngine(tcfg, device="cpu", params=tight.params,
                           debug_invariants=True, **kw)
    reqs = [Request(p.copy(), max_new=20, frames=f)
            for p, f in zip(prompts, frames)]
    outs = base.run(reqs)
    assert base.stats["preemptions"] == 0 and base.stats["encodes"] == 2
    for r, g, j, log in zip(reqs, got, jouts, logs):
        assert g == outs[r.rid].tolist()
        assert_same_or_near_tie(g, j, log)


@pytest.mark.parametrize("kw,match", [
    ({"swap_space_bytes": 1 << 20}, "pure paged-KV runner"),
    ({"shared_index": object()}, "pure paged-KV runner"),
    ({"kv_dtype": "int8"}, "bf16 pools")])
def test_engine_refuses_what_the_reference_refuses(kw, match):
    with pytest.raises(ValueError, match=match):
        InferenceEngine(get_config(ARCH, smoke=True), device="cpu", **kw)


def test_runner_cache_and_cli(capsys):
    """EncDecRunner: no prefix caching, no packing (prefill_pack asked
    for, 1 given), the encoder cache counted in kv_cache_mib; the serve
    CLI serves whisper with random frames."""
    cfg = get_config(ARCH, smoke=True)
    assert type(make_runner(cfg)) is EncDecRunner
    eng = InferenceEngine(cfg, device="cpu", max_batch=2, block_size=16,
                          max_len=64, prefill_pack=4)
    assert eng.prefill_pack == 1 and not eng.sched.enable_prefix_caching
    assert eng.cache["cross"]["xk"].shape == (
        cfg.num_layers, 2, cfg.encoder_seq_len, cfg.num_kv_heads,
        cfg.head_dim)
    pools = eng.cache["self"]["k"].numel() * 2 * 2
    assert eng.stats["kv_cache_mib"] == round(
        (pools + 2 * encoder_cache_bytes(cfg)) / 2 ** 20, 3)
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests",
                "2", "--max-new", "3", "--prompt-len", "8", "--max-len",
                "64"])
    out = capsys.readouterr().out
    assert "runner=EncDecRunner" in out and "encodes=2" in out

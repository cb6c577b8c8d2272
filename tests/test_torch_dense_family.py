"""The rest of the dense family in the port, against the JAX package at
smoke size: qwen3_32b (qk-norm), starcoder2_3b (LayerNorm, ungated GeLU
MLP, tied head) and gemma2_27b (alternating local/global layers, both
softcaps, post-block norms, the embedding scale, a tied head).

Per arch (``test_torch_port_rules.py`` holds the configs field for
field): ``params_from_jax`` carries every leaf of every layer in layer
order (the two-kind gemma2 stack included) and ``init_model`` draws the
same tree;
the serving forward (``prefill_chunk_paged`` over two chunks,
``decode_step_paged`` with an idle slot, then ``prefill_chunk_ragged``
packing two fresh prompts) gives the reference's logits and page pools,
gemma2's prompts longer than its 16-token window so the local layers
mask; the training loss equals ``repro.models.api.loss_fn``. And
``embed``'s scale rounds sqrt(d) to bf16 before the multiply, at a width
whose root is not a bf16 number."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ParallelConfig as JPar
from repro.config import get_config as jax_get_config
from repro.models import api as japi
from repro.models import embedding as jemb
from repro.models import transformer as jtf
from repro.serving.kv_cache import init_paged_cache as jax_init_paged_cache
from repro_torch.config import ParallelConfig, get_config
from repro_torch.models import embedding as temb
from repro_torch.models import transformer as ttf
from repro_torch.models.api import init_model, loss_fn, params_from_jax
from repro_torch.serving.kv_cache import init_paged_cache
import torch_cpu  # noqa: F401  (one torch thread)

ARCHS = ["qwen3_32b", "starcoder2_3b", "gemma2_27b"]
# fp32: the ladder's 1e-5. bf16: test_torch_transformer.py's 5e-2 for a
# whole forward, not the ladder's per-op 1e-2: the two frameworks round
# bf16 activations at other places (XLA keeps fused intermediates in
# fp32), which after two to four layers moves logits by up to 0.018 and
# a pool row by up to 0.024 of its norm (measured at these sizes)
TOL = {"float32": 1e-5, "bfloat16": 5e-2}
JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _setup(mesh, arch, dtype="bfloat16"):
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), dtype=dtype)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    with jax.set_mesh(mesh):
        pf, _ = japi.init_model(jcfg, jax.random.key(0))
        tree = jax.tree.map(lambda x: np.asarray(x.astype(JD[dtype])), pf)
    return jcfg, tcfg, tree


def _flat(tree, prefix=""):
    """{"a/b/c": leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_carries_every_leaf(mesh, arch):
    """Layer l is ``sub{l % P}[l // P]`` of the period-stacked tree, leaf
    for leaf and bit for bit; the arch's own leaves are there (qk-norm
    scales, LayerNorm biases, post-block norms); ``init_model`` draws the
    same tree, shapes and dtypes."""
    _, tcfg, tree = _setup(mesh, arch)
    p = params_from_jax(tree, tcfg, "cpu")
    P = len(tree["blocks"])
    assert P == len(tcfg.block_pattern) and len(p["layers"]) == \
        tcfg.num_layers
    for layer, lp in enumerate(p["layers"]):
        want = _flat(tree["blocks"][f"sub{layer % P}"])
        got = _flat(lp)
        assert set(got) == set(want)
        for name, t in got.items():
            np.testing.assert_array_equal(
                t.float().numpy(),
                np.asarray(want[name][layer // P], np.float32),
                err_msg=f"layer {layer} {name}")
    for grp in ("embed", "final_norm"):
        for name, t in _flat(p[grp]).items():
            np.testing.assert_array_equal(
                t.float().numpy(),
                np.asarray(_flat(tree[grp])[name], np.float32))
    extra = {"qwen3_32b": ["attn/q_norm", "attn/k_norm"],
             "starcoder2_3b": ["norm/bias", "norm2/bias"],
             "gemma2_27b": ["post_norm/scale", "post_norm2/scale"]}[arch]
    assert all(k in _flat(p["layers"][1]) for k in extra)
    assert ("head" in p["embed"]) == (not tcfg.tie_embeddings)
    own = init_model(tcfg, seed=0, device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda t: 0, own)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, p))
    assert all(a.shape == b.shape and a.dtype == b.dtype for a, b in zip(
        jax.tree.leaves(own), jax.tree.leaves(p)))


def _pools_to_port(jcache, names, dtype):
    """The JAX package's period-stacked pools {"sub{i}": {name: (NP, ...)}}
    as the port's (num_layers, ...) pools in layer order."""
    P = len(jcache)
    NP = next(iter(jcache.values()))["k"].shape[0]
    return {n: torch.from_numpy(np.stack([
        np.asarray(jcache[f"sub{layer % P}"][n][layer // P], np.float32)
        for layer in range(P * NP)])).to(dtype) for n in names}


def _compare(lj, lt, vocab, tol):
    lj = np.asarray(lj, np.float32)[..., :vocab]
    lt = lt.float().numpy()[..., :vocab]
    np.testing.assert_allclose(lt, lj, atol=tol, rtol=tol)
    np.testing.assert_array_equal(lt.argmax(-1), lj.argmax(-1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_forward_matches_reference(mesh, arch, dtype):
    """Chunked prefill of a 41-token prompt (25 + 16 rows), a decode step
    beside an idle slot, then two fresh prompts packed into one ragged
    row: logits and every pool equal the reference's within the ladder."""
    jcfg, tcfg, tree = _setup(mesh, arch, dtype)
    tp = params_from_jax(tree, tcfg, "cpu")
    jp = jax.tree.map(jnp.asarray, tree)
    tol = TOL[dtype]
    N, bs, nb = 24, 8, 8
    jcache = jax_init_paged_cache(jcfg, N, bs, dtype=JD[dtype])
    tcache = init_paged_cache(tcfg, N, bs, "cpu")
    tcache = {n: t.to(TD[dtype]) for n, t in tcache.items()}
    pcfg = JPar(remat="none")
    rng = np.random.default_rng(3)
    V = jcfg.vocab_size
    prompt = rng.integers(0, V, 41).astype(np.int32)
    table = np.arange(1, nb + 1, dtype=np.int32)[None]      # blocks 1-8

    def both(jfn, tfn, b):
        with jax.set_mesh(mesh):
            lj, jc = jax.jit(lambda p, c, b: jfn(p, c, b, jcfg, pcfg))(
                jp, jcache, {k: jnp.asarray(v) for k, v in b.items()})
        lt, _ = tfn(tp, tcache, {k: torch.from_numpy(v)
                                 for k, v in b.items()}, tcfg)
        _compare(lj, lt, V, tol)
        want = _pools_to_port(jc, ("k", "v"), torch.float32)
        for n in ("k", "v"):
            # each head row within the tolerance relative to its norm: a
            # rope term that rounds one bf16 ulp apart can move a small
            # element that rope formed by cancellation by that whole ulp
            got, ref = tcache[n].float()[:, 1:], want[n][:, 1:]
            err = (got - ref).norm(dim=-1) / ref.norm(dim=-1).clamp(min=1)
            assert float(err.max()) <= tol, (n, float(err.max()))
        return jc

    C = 25
    for start, n in ((0, 25), (25, 16)):
        toks = np.zeros((1, C), np.int32)
        toks[0, :n] = prompt[start:start + n]
        jcache = both(jtf.prefill_chunk_paged, ttf.prefill_chunk_paged, {
            "tokens": toks, "q_start": np.array([start], np.int32),
            "q_lens": np.array([n], np.int32), "block_tables": table,
            "ctx_lens": np.array([start + n], np.int32)})
    jcache = both(jtf.decode_step_paged, ttf.decode_step_paged, {
        "token": np.array([[7], [0]], np.int32),           # slot 1 idle
        "pos": np.array([41, 0], np.int32),
        "block_tables": np.concatenate([table, np.zeros_like(table)]),
        "ctx_lens": np.array([42, 0], np.int32)})
    # two fresh prompts (20 and 30 tokens) in one 56-row ragged chunk
    lens, T = (20, 30), 56
    toks = np.zeros((1, T), np.int32)
    pos = np.zeros((1, T), np.int32)
    row_seq = np.zeros(T, np.int32)
    starts, ends, off = [], [], 0
    for s, n in enumerate(lens):
        toks[0, off:off + n] = rng.integers(0, V, n)
        pos[0, off:off + n] = np.arange(n)
        row_seq[off:off + n] = s
        starts.append(off)
        ends.append(off + n)
        off += n
    tables = np.array([list(range(9, 17)), list(range(17, 24)) + [0]])
    jcache = both(jtf.prefill_chunk_ragged, ttf.prefill_chunk_ragged, {
        "tokens": toks, "positions": pos,
        "starts": np.array(starts, np.int32),
        "ends": np.array(ends, np.int32), "row_seq": row_seq,
        "block_tables": tables.astype(np.int32),
        "ctx_lens": np.array(lens, np.int32)})


def test_embed_scale_rounds_sqrt_d_to_bf16(mesh):
    """gemma2's embedding scale at its full width d = 4608 over a tiny
    vocab: sqrt(4608) = 67.88 is 68.0 in bf16, and the reference
    multiplies by that bf16 number. The port's rows equal the reference's
    bit for bit, and differ from a multiply by the fp32 root."""
    cfg = dataclasses.replace(get_config("gemma2_27b", smoke=True),
                              d_model=4608)
    jcfg = dataclasses.replace(jax_get_config("gemma2_27b", smoke=True),
                               d_model=4608)
    rng = np.random.default_rng(5)
    table = rng.normal(0, 0.02, (256, 4608)).astype(np.float32)
    tokens = rng.integers(-3, 260, (2, 9)).astype(np.int32)
    tt = torch.from_numpy(table).bfloat16()
    with jax.set_mesh(mesh):
        want = jemb.embed(jnp.asarray(table, jnp.bfloat16),
                          jnp.asarray(tokens), jcfg)
    want = np.asarray(want.astype(jnp.float32))
    got = temb.embed(tt, torch.from_numpy(tokens), cfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    plain = temb.embed(tt, torch.from_numpy(tokens),
                       dataclasses.replace(cfg, embedding_scale=False))
    assert not torch.equal(plain * math.sqrt(4608), got)


@pytest.mark.parametrize("arch", ARCHS)
def test_training_loss_matches_reference(mesh, arch):
    """forward_loss from the same fp32 masters on the same batch, remat
    full: the loss within 1e-2 of the reference's (bf16 activations)."""
    jcfg, tcfg = jax_get_config(arch, smoke=True), get_config(arch,
                                                               smoke=True)
    with jax.set_mesh(mesh):
        pf, _ = japi.init_model(jcfg, jax.random.key(0))
    masters = jax.tree.map(np.asarray, pf)
    rng = np.random.default_rng(9)
    batch = {k: rng.integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
             for k in ("tokens", "labels")}
    with jax.set_mesh(mesh):
        jl, _ = japi.loss_fn(jax.tree.map(jnp.asarray, masters),
                             {k: jnp.asarray(v) for k, v in batch.items()},
                             jcfg, JPar(remat="full"))
    params = params_from_jax(masters, tcfg, "cpu")
    with torch.no_grad():
        tl, metr = loss_fn(params, {k: torch.from_numpy(v)
                                    for k, v in batch.items()}, tcfg,
                           ParallelConfig(remat="full"))
    assert abs(float(tl) - float(jl)) <= 1e-2, (float(tl), float(jl))
    assert float(metr["aux"]) == 0.0

"""The port's Mamba2 layers, SSD scan and slot state against the JAX
package at smoke size on the CPU.

* ``ssd_chunked`` (the ``ssd`` kernel's plain version) and ``ssd_ref``
  against the JAX ``ssd_chunked``, the Pallas ``ssd`` in interpret mode
  and the JAX ``ssd_ref``, over ``tests/test_kernels.py``'s SSD cases.
* ``mamba_block``, ``mamba_chunk`` (ragged q_lens, a fresh and a carried
  state) and ``mamba_decode`` against theirs, with the weights of a JAX
  smoke model through ``params_from_jax``; chunked == monolithic inside
  the port (the scan's chunking invariants bit for bit).
* The serving forward (``prefill_chunk_paged`` / ``decode_step_paged``) of
  mamba2 and zamba2 against the JAX package's, states and KV included.
* ``SlotStateCache`` driven by one random walk beside the JAX one; the
  slot-state layout and bytes; the kernel wrapper's refusals.
* The CUDA kernel's operand rounding, emulated on the CPU at mamba2's
  widths over 8 chunks, against the JAX oracle ``ssd_ref``. (The kernel
  itself is held on the card by ``test_torch_ssm_cuda.py``.)

Tolerances: fp32 paths 1e-4 (the two frameworks sum in other orders;
measured below 4e-6); bf16 block outputs 5e-2 of the output's largest
magnitude (bf16 activations round at other places: XLA may keep fused
intermediates in fp32).
"""

import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ParallelConfig, get_config as jax_get_config
from repro.kernels import ref as jref
from repro.kernels.ssd import ssd as jax_ssd_pallas
from repro.models import api as japi
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro.serving.cache import SlotStateCache as JSlots
from repro.serving.cache import init_slot_state as jax_init_slot_state
from repro.serving.cache import slot_state_bytes as jax_slot_state_bytes
from repro.serving.kv_cache import block_bytes as jax_block_bytes
from repro.serving.runners import make_runner as jax_make_runner
from repro_torch.config import get_config
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd as ssd_k
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf
from repro_torch.models.api import init_model, params_from_jax
from repro_torch.serving.cache import (SlotStateCache, init_slot_state,
                                       slot_state_bytes)
from repro_torch.serving.kv_cache import (attn_layer_stacks, block_bytes,
                                          mamba_layer_stacks)
from repro_torch.serving.runners import make_runner
import torch_cpu  # noqa: F401  (one torch thread)

FP32_TOL = 1e-4
BF16_TOL = 5e-2
SSD_CASES = [                    # (b, S, nh, hp, G, N, Q), test_kernels.py
    (2, 64, 4, 16, 1, 16, 16),
    (1, 128, 8, 64, 1, 64, 32),
    (2, 96, 4, 32, 2, 16, 16),
]
ARCHS = ("mamba2_370m", "zamba2_2p7b")


def _ssd_inputs(rng, b, S, nh, hp, G, N):
    x = rng.normal(0, 1, (b, S, nh, hp)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, (b, S, nh)).astype(np.float32)
    A = -rng.uniform(0.5, 4, (nh,)).astype(np.float32)
    B = rng.normal(0, 1, (b, S, G, N)).astype(np.float32)
    C = rng.normal(0, 1, (b, S, G, N)).astype(np.float32)
    h0 = (0.5 * rng.normal(0, 1, (b, nh, hp, N))).astype(np.float32)
    return x, dt, A, B, C, h0


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol, rtol=0)


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_plain_vs_reference(case):
    """Port ``ssd_chunked`` / ``ssd_ref`` against the JAX XLA path, the
    Pallas kernel in interpret mode and the JAX step-by-step oracle; the
    CPU dispatch of ``ops.ssd`` is the port's ``ssd_chunked``."""
    b, S, nh, hp, G, N, Q = case
    arrays = _ssd_inputs(np.random.default_rng(SSD_CASES.index(case)),
                         b, S, nh, hp, G, N)
    j = [jnp.asarray(a) for a in arrays]
    t = [torch.from_numpy(a) for a in arrays]
    y_t, h_t = tssm.ssd_chunked(*t[:5], Q, h0=t[5])
    y_r, h_r = tref.ssd_ref(*t[:5], h0=t[5])
    y_o, h_o = ops.ssd(*t[:5], chunk=Q, h0=t[5])
    assert torch.equal(y_o, y_t) and torch.equal(h_o, h_t)
    for y_j, h_j in (jssm.ssd_chunked(*j[:5], chunk=Q, h0=j[5]),
                     jax_ssd_pallas(*j[:5], chunk=Q, h0=j[5], interpret=True),
                     jref.ssd_ref(*j[:5], h0=j[5])):
        _close(y_t, y_j, FP32_TOL)
        _close(h_t, h_j, FP32_TOL)
        _close(y_r, y_j, FP32_TOL)
        _close(h_r, h_j, FP32_TOL)
    # without h0 the scan starts from zeros
    y0, h0 = tssm.ssd_chunked(*t[:5], Q)
    y0j, h0j = jssm.ssd_chunked(*j[:5], chunk=Q)
    _close(y0, y0j, FP32_TOL)
    _close(h0, h0j, FP32_TOL)


def test_ssd_decode_step_and_segsum_vs_reference():
    rng = np.random.default_rng(3)
    b, nh, hp, G, N = 2, 4, 16, 2, 16
    x = rng.normal(0, 1, (b, nh, hp)).astype(np.float32)
    dt = rng.uniform(0.01, 0.1, (b, nh)).astype(np.float32)
    A = -rng.uniform(0.5, 2, (nh,)).astype(np.float32)
    B = rng.normal(0, 1, (b, G, N)).astype(np.float32)
    C = rng.normal(0, 1, (b, G, N)).astype(np.float32)
    h = rng.normal(0, 1, (b, nh, hp, N)).astype(np.float32)
    y_t, h_t = tssm.ssd_decode_step(*(torch.from_numpy(a)
                                      for a in (h, x, dt, A, B, C)))
    y_j, h_j = jssm.ssd_decode_step(*(jnp.asarray(a)
                                      for a in (h, x, dt, A, B, C)))
    _close(y_t, y_j, FP32_TOL)
    _close(h_t, h_j, FP32_TOL)
    la = rng.normal(0, 1, (3, 7)).astype(np.float32)
    s_t = tssm.segsum(torch.from_numpy(la)).numpy()
    s_j = np.asarray(jssm.segsum(jnp.asarray(la)))
    np.testing.assert_array_equal(np.isinf(s_t), np.isinf(s_j))
    _close(np.where(np.isinf(s_t), 0, s_t), np.where(np.isinf(s_j), 0, s_j),
           FP32_TOL)


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _jax_tree(mesh, arch, dtype=jnp.bfloat16):
    cfg = jax_get_config(arch, smoke=True)
    with jax.set_mesh(mesh):
        pf, _ = japi.init_model(cfg, jax.random.key(0))
        return cfg, jax.tree.map(lambda x: np.asarray(x.astype(dtype)), pf)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_layers_vs_reference(mesh, dtype):
    """One mamba layer of the mamba2 smoke model: the full-sequence block,
    two ragged chunks (fresh, then carried state) and a decode step."""
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    cfg, tree = _jax_tree(mesh, "mamba2_370m", jd)
    tcfg = get_config("mamba2_370m", smoke=True)
    tp = params_from_jax(tree, tcfg, "cpu")["layers"][1]["mamba"]
    jp = jax.tree.map(lambda a: jnp.asarray(a[1]),
                      tree["blocks"]["sub0"]["mamba"])
    rng = np.random.default_rng(5)
    B, C, d = 2, 11, cfg.d_model
    x = rng.normal(0, 1, (B, 2 * C, d)).astype(np.float32)
    xj, xt = jnp.asarray(x, jd), torch.from_numpy(x).to(td)

    def cmp(a, b):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        tol = FP32_TOL if dtype == "float32" else \
            BF16_TOL * max(1.0, float(np.abs(b).max(initial=0.0)))
        _close(a, b, tol)

    block = jax.jit(jssm.mamba_block, static_argnums=2)
    chunk = jax.jit(jssm.mamba_chunk, static_argnums=2)
    decode = jax.jit(jssm.mamba_decode, static_argnums=2)
    yj, (tj, hj) = block(jp, xj, cfg)
    with torch.no_grad():
        yt, (tt, ht) = tssm.mamba_block(tp, xt, tcfg)
    cmp(yt.float(), yj.astype(jnp.float32))
    cmp(tt.float(), tj.astype(jnp.float32))
    cmp(ht, hj)

    s = cfg.ssm
    di, gn = s.d_inner(d), s.n_groups * s.state_dim
    zero = (np.zeros((B, s.conv_kernel - 1, di + 2 * gn), np.float32),
            np.zeros((B, s.n_heads(d), s.head_dim, s.state_dim), np.float32))
    jstate = (jnp.asarray(zero[0], jd), jnp.asarray(zero[1]))
    tstate = (torch.from_numpy(zero[0]).to(td), torch.from_numpy(zero[1]))
    for lo, q_lens in ((0, [C, 7]), (C, [C, 0])):     # fresh, then carried
        ql = np.asarray(q_lens, np.int32)
        yj, jstate = chunk(jp, xj[:, lo:lo + C], cfg, jstate,
                           jnp.asarray(ql))
        with torch.no_grad():
            yt, tstate = tssm.mamba_chunk(tp, xt[:, lo:lo + C], tcfg, tstate,
                                          torch.from_numpy(ql))
        for b in range(B):
            cmp(yt[b, :ql[b]].float(), yj[b, :ql[b]].astype(jnp.float32))
        cmp(tstate[0].float(), jstate[0].astype(jnp.float32))
        cmp(tstate[1], jstate[1])
    yj, jstate = decode(jp, xj[:, :1], cfg, jstate)
    with torch.no_grad():
        yt, tstate = tssm.mamba_decode(tp, xt[:, :1], tcfg, tstate)
    cmp(yt.float(), yj.astype(jnp.float32))
    cmp(tstate[0].float(), jstate[0].astype(jnp.float32))
    cmp(tstate[1], jstate[1])


def test_ssd_plain_chunking_invariants_bitwise():
    """The plain scan keeps the kernel's two invariants, bit for bit: one
    call over 4Q rows == calls over 2Q, Q and Q rows with the state
    carried; rows with dt = 0 leave h_last and earlier rows' y unchanged
    whatever they hold, and a whole chunk of them is the identity."""
    b, nh, hp, G, N, Q = 2, 4, 16, 2, 16, 8
    rng = np.random.default_rng(4)
    x, dt, A, B, C, h0 = (torch.from_numpy(a) for a in
                          _ssd_inputs(rng, b, 4 * Q, nh, hp, G, N))
    y, h = tssm.ssd_chunked(x, dt, A, B, C, Q, h0=h0)
    ys, hc = [], h0
    for lo, hi in ((0, 2 * Q), (2 * Q, 3 * Q), (3 * Q, 4 * Q)):
        yc, hc = tssm.ssd_chunked(x[:, lo:hi], dt[:, lo:hi], A, B[:, lo:hi],
                                  C[:, lo:hi], Q, h0=hc)
        ys.append(yc)
    assert torch.equal(torch.cat(ys, dim=1), y) and torch.equal(hc, h)
    n = 13
    dt0 = dt.clone()
    dt0[:, n:] = 0.0
    x2, _, _, B2, C2, _ = (torch.from_numpy(a) for a in
                           _ssd_inputs(rng, b, 4 * Q, nh, hp, G, N))
    for t, t2 in ((x, x2), (B, B2), (C, C2)):
        t2[:, :n] = t[:, :n]
    y1, h1 = tssm.ssd_chunked(x, dt0, A, B, C, Q, h0=h0)
    y2, h2 = tssm.ssd_chunked(x2, dt0, A, B2, C2, Q, h0=h0)
    assert torch.equal(h1, h2) and torch.equal(y1[:, :n], y2[:, :n])
    y3, h3 = tssm.ssd_chunked(x[:, :2 * Q], dt0[:, :2 * Q], A, B[:, :2 * Q],
                              C[:, :2 * Q], Q, h0=h0)
    assert torch.equal(h3, h1)


def test_mamba_chunked_matches_monolithic(mesh):
    """Chunk boundaries on ``chunk_size`` multiples (the last chunk
    ragged), each chunk right-padded to one width as the engine runs it,
    against the monolithic block, in fp32. Not bit for bit on the CPU:
    its GEMMs round a row by its position within the call (the engine's
    greedy tokens are held chunked == monolithic in
    tests/test_torch_ssm_engine.py)."""
    _, tree = _jax_tree(mesh, "mamba2_370m", jnp.float32)
    tcfg = dataclasses.replace(get_config("mamba2_370m", smoke=True),
                               dtype="float32")
    tp = params_from_jax(tree, tcfg, "cpu")["layers"][0]["mamba"]
    Q = tcfg.ssm.chunk_size
    x = torch.from_numpy(np.random.default_rng(6).normal(
        0, 1, (1, 3 * Q + 5, tcfg.d_model)).astype(np.float32))
    with torch.no_grad():
        y_mono, (tail_m, h_m) = tssm.mamba_block(tp, x, tcfg)
        s = tcfg.ssm
        state = (torch.zeros_like(tail_m),
                 torch.zeros((1, s.n_heads(tcfg.d_model), s.head_dim,
                              s.state_dim)))
        ys = []
        for lo, n in ((0, 2 * Q), (2 * Q, Q), (3 * Q, 5)):
            xc = torch.zeros((1, 2 * Q, tcfg.d_model))
            xc[:, :n] = x[:, lo:lo + n]
            y, state = tssm.mamba_chunk(tp, xc, tcfg, state,
                                        torch.tensor([n]))
            ys.append(y[:, :n])
    _close(torch.cat(ys, dim=1), y_mono, 1e-5)
    _close(state[0], tail_m, 1e-5)
    _close(state[1], h_m, 1e-5)


def _layer_states(jcache, cfg, rows):
    """JAX per-stack (conv, ssm) caches -> the port's per-layer arrays:
    layer p * P + i is stack ``sub{i}``'s period p."""
    kinds, NP = jtf.period_structure(cfg)
    P = len(kinds)
    return [np.stack([np.asarray(jcache[f"sub{l % P}"][j][l // P][rows],
                                 np.float32) for l in range(cfg.num_layers)])
            for j in (0, 1)]


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_forward_vs_reference(mesh, arch):
    """fp32 smoke model: two prefill chunks of two rows (ragged q_lens),
    then a decode step with one active and one idle slot. Logits, mamba
    states and the shared block's KV pools against the JAX package's."""
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                               dtype="float32")
    tcfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    with jax.set_mesh(mesh):
        pf, _ = japi.init_model(jcfg, jax.random.key(0))
    tree = jax.tree.map(np.asarray, pf)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_jax(tree, tcfg, "cpu")
    pcfg = ParallelConfig(remat="none")
    nb, bs, B, C = 9, 8, 2, 12
    jcache = jax_make_runner(jcfg, pcfg).init_cache(nb, bs, B)
    jcache = jax.tree.map(lambda a: a.astype(jnp.float32)
                          if a.dtype == jnp.bfloat16 else a, jcache)
    tcache = make_runner(tcfg).init_cache(nb, bs, B, "cpu")
    tcache = {k: v.float() for k, v in tcache.items()}
    rng = np.random.default_rng(7)
    tables = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)

    def both(fn_j, fn_t, batch):
        nonlocal jcache
        with jax.set_mesh(mesh):
            lj, jcache = jax.jit(fn_j, static_argnums=(3, 4))(
                jp, jcache, {k: jnp.asarray(v) for k, v in batch.items()},
                jcfg, pcfg)
        with torch.no_grad():
            lt, _ = fn_t(tp, tcache, {k: torch.from_numpy(v)
                                      for k, v in batch.items()}, tcfg)
        return np.asarray(lj), lt.numpy()

    for q_start, q_lens in (([0, 0], [C, 9]), ([C, 9], [C, 3])):
        qs, ql = np.asarray(q_start, np.int32), np.asarray(q_lens, np.int32)
        batch = {"tokens": rng.integers(0, 256, (B, C)).astype(np.int32),
                 "q_start": qs, "q_lens": ql, "block_tables": tables,
                 "ctx_lens": qs + ql}
        lj, lt = both(jtf.prefill_chunk_paged, ttf.prefill_chunk_paged, batch)
        _close(lt[:, :256], lj[:, :256], FP32_TOL)
    before = {k: v.clone() for k, v in tcache.items()}
    pos = np.asarray([2 * C, 0], np.int32)
    batch = {"token": rng.integers(0, 256, (B, 1)).astype(np.int32),
             "pos": pos, "block_tables": tables * np.asarray([[1], [0]]),
             "ctx_lens": np.asarray([2 * C + 1, 0], np.int32)}
    lj, lt = both(jtf.decode_step_paged, ttf.decode_step_paged, batch)
    _close(lt[0, :256], lj[0, :256], FP32_TOL)
    # active slot: the JAX package's new state; idle slot: kept
    conv_j, ssm_j = _layer_states(jcache, jcfg, 0)
    _close(tcache["conv"][:, 0], conv_j, FP32_TOL)
    _close(tcache["ssm"][:, 0], ssm_j, FP32_TOL)
    assert torch.equal(tcache["conv"][:, 1], before["conv"][:, 1])
    assert torch.equal(tcache["ssm"][:, 1], before["ssm"][:, 1])
    if tcfg.shared_attn_period:
        for name in ("k", "v"):
            _close(tcache[name][:, 1:], np.asarray(
                jcache["shared"][name])[:, 1:], FP32_TOL)
    else:
        assert "k" not in tcache


@pytest.mark.parametrize("arch", ARCHS)
def test_params_layout_and_init_match_reference(mesh, arch):
    """``params_from_jax`` splits layer p * P + i out of stack ``sub{i}``
    and carries the shared block; ``init_model`` draws the same tree with
    init_mamba's constants."""
    cfg, tree = _jax_tree(mesh, arch)
    tcfg = get_config(arch, smoke=True)
    p = params_from_jax(tree, tcfg, "cpu")
    kinds, NP = jtf.period_structure(cfg)
    P = len(kinds)
    assert len(p["layers"]) == cfg.num_layers == P * NP
    for layer, lp in enumerate(p["layers"]):
        want = tree["blocks"][f"sub{layer % P}"]["mamba"]["w_out"][layer // P]
        np.testing.assert_array_equal(lp["mamba"]["w_out"].float().numpy(),
                                      np.asarray(want, np.float32))
    assert ("shared" in p) == bool(cfg.shared_attn_period)
    own = init_model(tcfg, seed=0, device="cpu")
    shapes = jax.tree.map(lambda t: (tuple(t.shape), t.dtype), own)
    assert shapes == jax.tree.map(lambda t: (tuple(t.shape), t.dtype), p)
    m = own["layers"][0]["mamba"]
    nh = tcfg.ssm.n_heads(tcfg.d_model)
    np.testing.assert_allclose(
        m["A_log"].float().numpy(),
        np.log(np.linspace(1.0, 16.0, nh)), atol=1e-2)
    assert (m["D"] == 1).all() and (m["dt_bias"] == 0).all()
    assert (m["norm_scale"] == 1).all()
    assert abs(m["conv_x"].float().std().item() - 0.5 * 0.88) < 0.05


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_slot_state_layout_and_bytes_match_reference(arch, smoke):
    jcfg, tcfg = jax_get_config(arch, smoke), get_config(arch, smoke)
    assert slot_state_bytes(tcfg) == jax_slot_state_bytes(jcfg)
    assert block_bytes(tcfg, 16) == jax_block_bytes(jcfg, 16)
    from repro.serving.kv_cache import attn_layer_stacks as j_attn
    from repro.serving.kv_cache import mamba_layer_stacks as j_mamba
    assert attn_layer_stacks(tcfg) == j_attn(jcfg)
    assert mamba_layer_stacks(tcfg) == j_mamba(jcfg)
    if smoke:
        st = init_slot_state(tcfg, 3, "cpu")
        jst = jax_init_slot_state(jcfg, 3)
        n = sum(jst[k][0].shape[0] for k in jst)
        assert st["conv"].shape == (n,) + jst["sub0"][0].shape[1:]
        assert st["ssm"].shape == (n,) + jst["sub0"][1].shape[1:]
        assert st["conv"].dtype == torch.bfloat16
        assert st["ssm"].dtype == torch.float32


@pytest.mark.parametrize("seed", range(4))
def test_slot_state_cache_random_walk_matches_reference(seed):
    """allocate (lowest free or a chosen slot) / free, on both caches in
    lock step: equal results or equal exceptions, equal maps."""
    rng = random.Random(seed)
    a, b = JSlots(4), SlotStateCache(4)
    rids, next_rid = [], 0
    for _ in range(200):
        op = rng.randrange(3)
        if op < 2:
            next_rid += 1
            rid = next_rid if rng.random() < 0.9 or not rids else rids[0]
            slot = None if op == 0 else rng.randrange(-1, 5)
            out = []
            for c in (a, b):
                try:
                    out.append(("ok", c.allocate(rid, slot)))
                except (KeyError, MemoryError, ValueError) as e:
                    out.append(("err", type(e)))
            assert out[0] == out[1], out
            if out[0][0] == "ok":
                rids.append(rid)
        elif rids:
            rid = rids.pop(rng.randrange(len(rids)))
            assert a.free(rid) == b.free(rid)
        assert (a._slot_of, a._rid_of) == (b._slot_of, b._rid_of)
        assert a.num_free == b.num_free and a.free_slots() == b.free_slots()
        assert a.stats().__dict__ == b.stats().__dict__
        b.check()


def test_ssd_wrapper_refuses_cpu_and_malformed_inputs():
    """The kernel wrapper launches or raises: CPU tensors never reach a
    hidden fallback, and shapes the kernel does not take are named."""
    rng = np.random.default_rng(9)
    x, dt, A, B, C, h0 = (torch.from_numpy(a) for a in
                          _ssd_inputs(rng, 1, 32, 4, 16, 1, 16))
    x, B, C = x.bfloat16(), B.bfloat16(), C.bfloat16()
    with pytest.raises(ValueError, match="CUDA"):
        ssd_k.ssd(x, dt, A, B, C, chunk=16, h0=h0)
    with pytest.raises(ValueError, match="divide"):
        ssd_k.ssd(x, dt, A, B, C, chunk=24)
    with pytest.raises(ValueError, match="x must be bf16"):
        ssd_k.ssd(x.float(), dt, A, B, C, chunk=16)
    with pytest.raises(ValueError, match="dt must be"):
        ssd_k.ssd(x, dt.double(), A, B, C, chunk=16)
    with pytest.raises(ValueError, match="h0 must be"):
        ssd_k.ssd(x, dt, A, B, C, chunk=16, h0=h0[..., :8])
    with pytest.raises(ValueError, match="multiple of 16"):
        ssd_k.ssd(x[..., :8], dt, A, B, C, chunk=16)
    with pytest.raises(ValueError, match="up to 256"):
        ssd_k.ssd(x, dt, A, *(t.repeat(1, 1, 1, 17) for t in (B, C)),
                  chunk=16)
    # B and C may be strided: slices of a wider row, as the conv output's
    # are; a group's N values must be dense and the row stride a multiple
    # of 8 elements (16 bytes)
    wide = torch.cat([B, C, B], dim=-1)                 # rows of 48
    with pytest.raises(ValueError, match="CUDA"):
        ssd_k.ssd(x, dt, A, wide[..., :16], wide[..., 16:32], chunk=16)
    odd = torch.cat([B, C, B[..., :4]], dim=-1)         # rows of 36
    with pytest.raises(ValueError, match="multiples of 8"):
        ssd_k.ssd(x, dt, A, odd[..., :16], odd[..., 16:32], chunk=16)
    with pytest.raises(ValueError, match="dense"):
        ssd_k.ssd(x, dt, A, wide[..., ::3], C, chunk=16)
    assert ssd_k.ssd.launches == 0


def _bf16_parts(v):
    """fp32 v as the kernel's two bf16 operand parts: hi = v truncated to
    bf16 (its top 16 bits), lo = v - hi truncated too."""
    def trunc(t):
        return (t.view(torch.int32) & -65536).view(torch.float32)
    hi = trunc(v)
    return hi, trunc(v - hi)


def _ssd_kernel_arithmetic(x, dt, A, B, C, Q, h0):
    """``csrc/ssd.cu``'s arithmetic in fp32 torch on the CPU: exact bf16
    products summed in fp32; the fp32 operand of each product with x or C
    (P, the state, W) split into bf16 hi + lo parts; dt and the decays
    folded into P and W; the decay mask a select. Off the diagonal 16-key
    step, exp(cs_i - cs_j) = exp(cs_i - cs_m) exp(cs_m - cs_j) with m the
    last key of j's step, as the kernel factors it. x, B, C bf16-valued
    fp32. Returns (y as bf16, h_last)."""
    b, S, nh, hp = x.shape
    rep = nh // B.shape[2]
    i = torch.arange(Q)[:, None]
    j = torch.arange(Q)[None, :]
    diag = (i // 16 == j // 16) & (j <= i)
    below = i // 16 > j // 16
    m = torch.clamp(torch.arange(Q) | 15, max=Q - 1)   # j's step's last key
    h, ys = h0, []
    for c0 in range(0, S, Q):
        xc, dtc = x[:, c0:c0 + Q], dt[:, c0:c0 + Q]
        Bh = B[:, c0:c0 + Q].repeat_interleave(rep, dim=2)
        Ch = C[:, c0:c0 + Q].repeat_interleave(rep, dim=2)
        cs = torch.cumsum(dtc * A, dim=1).permute(0, 2, 1)   # (b, nh, Q)
        dth = dtc.permute(0, 2, 1)
        cb = torch.einsum("bihn,bjhn->bhij", Ch, Bh)
        e_diag = torch.exp(torch.where(diag, cs[..., :, None]
                                       - cs[..., None, :], 0.0))
        r_row = torch.exp(torch.where(below, cs[..., :, None]
                                      - cs[..., None, m], 0.0))
        e_key = dth * torch.exp(cs[..., m] - cs)
        P = torch.where(diag, cb * e_diag * dth[..., None, :],
                        torch.where(below, cb * r_row * e_key[..., None, :],
                                    0.0))
        y = sum(torch.einsum("bihn,bhpn->bihp", Ch, part)
                for part in _bf16_parts(h))
        y = torch.exp(cs).permute(0, 2, 1)[..., None] * y
        y = y + sum(torch.einsum("bhij,bjhp->bihp", part, xc)
                    for part in _bf16_parts(P))
        W = (dth * torch.exp(cs[..., -1:] - cs)).permute(0, 2, 1)[..., None] \
            * Bh
        h = torch.exp(cs[..., -1])[..., None, None] * h + sum(
            torch.einsum("bjhp,bjhn->bhpn", xc, part)
            for part in _bf16_parts(W))
        ys.append(y)
    return torch.cat(ys, dim=1).bfloat16(), h


def test_ssd_kernel_arithmetic_vs_reference_over_chunks():
    """The CUDA kernel's operand rounding (bf16 hi + lo parts of P, the
    state and W by truncation, fp32 sums), emulated on the CPU at mamba2_370m's widths
    (nh 32, hp 64, N 128, G 1) over 8 chunks of 256 rows with h0 carried,
    against the JAX step-by-step oracle ``ssd_ref``: every y row within
    1e-2 of its norm, h_last within 1e-3 of max(1, |ref|), the kernel's
    tolerances on the card. A rounding that drifts over many chunks
    fails here without a card."""
    b, S, nh, hp, G, N, Q = 1, 8 * 256, 32, 64, 1, 128, 256
    x, dt, A, B, C, h0 = _ssd_inputs(np.random.default_rng(11), b, S, nh,
                                     hp, G, N)
    x, B, C = (np.asarray(torch.from_numpy(a).bfloat16().float())
               for a in (x, B, C))
    y_r, h_r = jref.ssd_ref(*(jnp.asarray(a) for a in (x, dt, A, B, C)),
                            h0=jnp.asarray(h0))
    y_r, h_r = (torch.from_numpy(np.array(a)) for a in (y_r, h_r))
    y_e, h_e = _ssd_kernel_arithmetic(
        *(torch.from_numpy(a) for a in (x, dt, A, B, C)), Q,
        torch.from_numpy(h0))
    a, r = y_e.float().flatten(0, -2), y_r.flatten(0, -2)
    rel = torch.nan_to_num((a - r).norm(dim=-1) / r.norm(dim=-1), nan=0.0)
    assert float(rel.max()) <= 1e-2
    assert float(((h_e - h_r).abs() / h_r.abs().clamp(min=1.0)).max()) \
        <= 1e-3

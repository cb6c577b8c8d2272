"""The training slice's kernels on the card: the flash forward (every
route: hd 8, 12 and 16 on "mma", 64, 80 and 128 on the wgmma template),
the gather (its 16-byte vector path and the 4-byte word path of the
dataflow core's narrow rows) and the sampled-softmax loss against their
plain versions,
and a training step on the card against the same step on the CPU. Every
test skips without a CUDA card. The file imports neither jax nor the JAX
package, so on a machine with a card and without jax it runs alone:

  PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_training_cuda.py
"""

import pytest
import torch

from repro_torch.config import OptimizerConfig, ParallelConfig, get_config
from repro_torch.data.pipeline import ShardedSource
from repro_torch.kernels import embedding as temb
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sampled_softmax as tss
from repro_torch.models import attention as tatt
from repro_torch.models.api import init_model
from repro_torch.optim import optimizers as topt
from repro_torch.spmd import steps as tsteps


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


FLASH_CASES = [  # B, Sq, Skv, H, K, hd, causal, window, cap, q_offset
    (2, 200, 200, 4, 2, 16, True, None, 50.0, 0),
    (1, 130, 300, 8, 2, 128, True, 64, None, 170),
    (2, 70, 150, 4, 4, 128, False, None, None, 0),
    # the edges of the hd-128 route's 128-row and 128-key tiles
    (2, 129, 129, 4, 2, 128, True, None, None, 0),
    (1, 255, 255, 8, 2, 128, True, None, None, 0),
    (2, 96, 130, 4, 2, 128, False, None, None, 0),
    (1, 148, 2048, 4, 2, 128, True, None, None, 1900),
    (1, 600, 600, 4, 2, 128, True, 100, 50.0, 0),
    # the hd-80 route (zamba2's shared block: H = K)
    (2, 200, 200, 4, 4, 80, True, None, None, 0),
    (1, 130, 300, 8, 8, 80, True, 64, 30.0, 170),
    (2, 70, 150, 4, 4, 80, False, None, None, 0),
    # the hd-64 route (whisper: H = K), the encoder's 1500 rows ragged
    (1, 1500, 1500, 4, 4, 64, False, None, None, 0),
    (2, 200, 200, 4, 4, 64, True, None, None, 0),
    (1, 130, 300, 8, 2, 64, True, 64, 30.0, 170),
    # hd 8 and 12 (the smoke configs) on the mma route's 16-value rows
    (2, 200, 200, 4, 2, 8, True, None, 50.0, 0),
    (2, 130, 300, 12, 2, 12, True, 64, None, 170),
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_vs_plain(case):
    """The kernel against dense_attention (each row within 1e-2 of its
    norm) and the plain lse (1e-3 absolute); FlashAttention's gradients
    within 1e-2 of each gradient's max (bf16 probabilities on the plain
    side); two launches equal bit for bit. Sq and Skv not multiples of
    the 64- and 128-row tiles; each head dim's route launched twice."""
    _need_card()
    B, Sq, Skv, H, K, hd, causal, window, cap, off = case
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    q, k, v, do = (torch.randn(s, generator=g, device="cuda").bfloat16()
                   for s in ((B, Sq, H, hd), (B, Skv, K, hd),
                             (B, Skv, K, hd), (B, Sq, H, hd)))
    opts = dict(causal=causal, window=window, cap=cap, q_offset=off)
    before = dict(tfa.flash_attention.launches)
    o, lse = tfa.flash_attention(q, k, v, **opts)
    o2, lse2 = tfa.flash_attention(q, k, v, **opts)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    route = tfa.route(hd)
    assert tfa.flash_attention.launches[route] == before.get(route, 0) + 2
    d = tatt.dense_attention(q, k, v, **opts).float()
    rel = (o.float() - d).norm(dim=-1) / d.norm(dim=-1)
    assert float(rel.max()) <= 1e-2
    _, plse = tref.flash_attention_fwd_plain(q, k, v, **opts)
    assert float((lse - plse).abs().max()) <= 1e-3
    grads = []
    for fn in (lambda *a: tfa.FlashAttention.apply(*a, causal, window, cap,
                                                   None, off),
               lambda *a: tatt.dense_attention(*a, **opts)):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        fn(*leaves).backward(do)
        grads.append([t.grad.float() for t in leaves])
    for a, b in zip(*grads):
        assert float((a - b).abs().max()) <= 1e-2 * float(b.abs().max())


# hd, B, H: at hd 64 the kernel takes 64-row blocks where 128-row ones
# would not give each of the H100's 132 SMs two (B 1 x H 4 x 12 query
# tiles), 128-row ones otherwise (B 8 x H 20); hd 80 always 128
@pytest.mark.parametrize("hd,B,H", [(64, 1, 4), (64, 8, 20), (80, 1, 4),
                                    (80, 8, 20)])
def test_flash_block_heights_vs_plain(hd, B, H):
    """The hd-64 and hd-80 routes at the block heights their rule picks
    against the plain version (each o row within 1e-2 of its norm, lse
    within 1e-3), at whisper's non-causal 1500 rows and at a ragged causal
    shape with a window and a q_offset."""
    _need_card()
    g = torch.Generator(device="cuda")
    g.manual_seed(hd + B)
    for Sq, Skv, opts in ((1500, 1500, dict(causal=False)),
                          (333, 1000, dict(causal=True, window=200,
                                           q_offset=667))):
        q = torch.randn((B, Sq, H, hd), generator=g, device="cuda").bfloat16()
        k, v = (torch.randn((B, Skv, H, hd), generator=g,
                            device="cuda").bfloat16() for _ in range(2))
        o, lse = tfa.flash_attention(q, k, v, **opts)
        po, plse = tref.flash_attention_fwd_plain(q, k, v, **opts)
        rel = (o.float() - po.float()).norm(dim=-1) / po.float().norm(dim=-1)
        assert float(rel.max()) <= 1e-2
        assert float((lse - plse).abs().max()) <= 1e-3


@pytest.mark.parametrize("T", [1, 8, 256, 4096])
def test_gather_kernel_vs_plain(T):
    """The gather kernel equals table[ids] bit for bit at glm4_9b's table
    width (4096 bf16), ids 0 and V - 1 and out-of-range ids among them,
    under jnp's rule (a negative id counts from the end, then the row is
    clamped into [0, V)); Gather's gradient equals the plain path's, the
    gradient of table[ids] with out-of-range ids dropped (a scatter-add
    over repeated ids)."""
    _need_card()
    g = torch.Generator(device="cuda")
    g.manual_seed(T)
    V, d = 5000, 4096
    table = torch.randn((V, d), generator=g, device="cuda").bfloat16()
    ids = torch.randint(0, V, (T,), generator=g, device="cuda",
                        dtype=torch.int32)
    edge = torch.tensor([0, V - 1, -1, V, -(2 ** 31), 2 ** 31 - 1, -V,
                         -V - 1], dtype=torch.int32, device="cuda")
    ids[:min(T, 8)] = edge[:min(T, 8)]
    before = temb.gather.launches
    out = temb.gather(table, ids)
    assert temb.gather.launches == before + 1
    wrapped = torch.where(ids < 0, ids + V, ids)
    assert torch.equal(out, table[wrapped.clamp(0, V - 1).long()])
    grad = torch.randn((T, d), generator=g, device="cuda").bfloat16()
    leaves = [table.clone().requires_grad_() for _ in range(2)]
    temb.Gather.apply(leaves[0], ids).backward(grad)
    temb.gather_plain(leaves[1], ids).backward(grad)
    assert torch.equal(leaves[0].grad, leaves[1].grad)


# the dataflow core's float32 rows: 4 bytes (a 1-D vector), 8 (Figure 3),
# 20, 64 (Figure 6's sparse table) and 2048 (the LM at d 512); then rows
# of 16-byte multiples at a 4-byte aligned offset, which take the words
# path too
NARROW_CASES = [  # d, T, offset in float32 words, path
    (1, 32, 0, "words"), (2, 4096, 0, "words"), (5, 33, 0, "words"),
    (16, 32, 0, "vector"), (512, 4096, 0, "vector"), (16, 1, 1, "words"),
    (512, 32, 3, "words"),
]


@pytest.mark.parametrize("d,T,offset,want", NARROW_CASES)
def test_gather_kernel_narrow_rows(d, T, offset, want):
    """float32 rows the 16-byte vectors cannot take go through the 4-byte
    word path and equal gather_plain bit for bit, negative and
    out-of-range ids included; the core's Gather (a 1-D vector, a
    Transpose view) launches the kernel too."""
    from repro_torch.core import ops as cops
    _need_card()
    g = torch.Generator(device="cuda")
    g.manual_seed(d * 7 + T)
    V = 1000
    base = torch.randn(V * d + offset, generator=g, device="cuda")
    table = base[offset:].view(V, d)
    assert temb.path(table) == want
    ids = torch.randint(-V, V, (T,), generator=g, device="cuda",
                        dtype=torch.int32)
    ids[:min(T, 3)] = torch.tensor([V, -V - 1, V - 1], dtype=torch.int32,
                                   device="cuda")[:min(T, 3)]
    before = temb.gather.launches
    assert torch.equal(temb.gather(table, ids), temb.gather_plain(table, ids))
    assert torch.equal(cops.gather(table.t(), ids[ids.abs() < d]),
                       table.t()[ids[ids.abs() < d].long()])
    vec = table[:, 0].contiguous()
    ok = ids[(ids >= -V) & (ids < V)]
    assert torch.equal(cops.gather(vec, ok), vec[ok.long()])
    assert temb.gather.launches == before + 3


@pytest.mark.parametrize("T,n,d,cap", [
    (300, 200, 256, None), (129, 200, 256, 30.0),
    # the GEMM launch's tile edges: n not a multiple of 256 and above one
    # range, n below one 256-column tile, T below one 128-row tile; d of
    # one and of three 64-value steps
    (4096, 8000, 64, None), (257, 64, 192, 30.0), (100, 8192, 64, None),
    (1, 3, 192, 30.0)])
def test_sampled_softmax_kernel_vs_plain(T, n, d, cap):
    """The kernel against its plain version (1e-4 relative: both sum
    exact bf16 products in fp32), accidental hits planted, T and n off
    the kernel's tiles; two launches equal bit for bit."""
    _need_card()
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    V = max(5000, 2 * n)
    table = (torch.randn((V, d), generator=g, device="cuda")
             / d ** 0.5).bfloat16()
    x = torch.randn((T, d), generator=g, device="cuda").bfloat16()
    lab = torch.randint(0, V, (T,), generator=g, device="cuda")
    sids = torch.randperm(V, generator=g, device="cuda")[:n]
    k = min(5, T, n)
    lab[:k] = sids[:k]
    a = tss.sampled_softmax_loss(x, table, lab, sids, cap=cap)
    b = tss.sampled_softmax_loss(x, table, lab, sids, cap=cap)
    assert torch.equal(a, b)
    want = tref.sampled_softmax_loss_ref(x, table, lab, sids, cap=cap)
    assert abs(float(a) - float(want)) <= 1e-4 * abs(float(want))


def test_train_step_card_vs_cpu():
    """Two training steps of glm4 smoke on the card (flash kernel, the
    gather kernel under autograd) and on the CPU from the same fp32
    masters: losses within 1e-2, grad norms within 1e-2 relative, every
    leaf's gradient finite and non-zero on the card."""
    _need_card()
    cfg = get_config("glm4_9b", smoke=True)
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=0)
    pcfg = ParallelConfig(remat="full", microbatches=2)
    init = init_model(cfg, 0, "cpu", torch.float32)
    src = ShardedSource(cfg, 32, seed=0)
    out = {}
    for dev in ("cuda", "cpu"):
        state = topt.init_train_state(ocfg, topt.tree_map(
            lambda t: t.to(dev, copy=True), init))
        params = topt.working_params(state)
        step = tsteps.make_train_step(cfg, pcfg, ocfg)
        hooked, ms = [], []
        launches = sum(tfa.flash_attention.launches.values())
        for i in range(2):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in src.batch(i, 4).items()}
            params, state, m = step(
                params, state, i, batch,
                grad_hook=lambda gr: hooked.append(
                    [bool(torch.isfinite(x).all() and (x != 0).any())
                     for x in topt.tree_leaves(gr)]))
            ms.append({k: float(v) for k, v in m.items()})
        if dev == "cuda":
            assert all(hooked[0])
            assert sum(tfa.flash_attention.launches.values()) - launches \
                == 2 * 2 * 2 * cfg.num_layers
        out[dev] = ms
    for a, b in zip(out["cuda"], out["cpu"]):
        assert abs(a["loss"] - b["loss"]) <= 1e-2
        assert abs(a["grad_norm"] - b["grad_norm"]) <= 1e-2 * b["grad_norm"]

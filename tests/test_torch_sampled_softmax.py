"""The port's sampled-softmax loss kernel op and the models' losses against
the JAX package.

On the CPU ``ops.sampled_softmax_loss`` runs the kernel's plain version
``ref.sampled_softmax_loss_ref``, held against the JAX Pallas kernel in
interpret mode and the JAX oracle on ``tests/test_kernels.py``'s cases
(1e-5 relative: both sum fp32 products, in other orders). The models'
``lm_loss`` and ``sampled_softmax_loss`` are held against the JAX ones on
a one-device mesh, values and gradients: 1e-5 relative in fp32, and in
bf16 1e-5 for the loss (fp32 logits of the same bf16 values) and 1e-2 of
each gradient's max (one bf16 rounding apart). The kernel runs only on a
card (``tests/test_torch_training_cuda.py`` and ``chip_smoke.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jax_get_config
from repro.kernels import ref as jref
from repro.kernels.sampled_softmax import \
    sampled_softmax_loss as jax_sampled_pallas
from repro.launch.mesh import make_host_mesh
from repro.models import embedding as jemb
from repro_torch.config import get_config
from repro_torch.kernels import ops
from repro_torch.kernels import sampled_softmax as tss
from repro_torch.models import embedding as temb
import torch_cpu  # noqa: F401  (one torch thread)

JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}
GRAD_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


@pytest.fixture(scope="module")
def mesh():
    return make_host_mesh(1, 1)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(x, np.float32)


def _close(a, b, tol):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape
    err = float(np.abs(a - b).max())
    assert err <= tol * max(float(np.abs(b).max()), 1e-30), err


@pytest.mark.parametrize("T,d,V,n,cap", [
    (100, 64, 512, 32, None), (256, 128, 1024, 64, 30.0),
    (513, 64, 300, 16, None)])
def test_plain_op_matches_pallas_and_oracle(T, d, V, n, cap):
    rng = np.random.default_rng(T)
    x = rng.normal(0, 1, (T, d)).astype(np.float32)
    table = (0.05 * rng.normal(0, 1, (V, d))).astype(np.float32)
    labels = rng.integers(0, V, (T,)).astype(np.int32)
    sids = rng.choice(V, n, replace=False).astype(np.int32)
    labels[:3] = sids[:3]                           # accidental hits
    lt = ops.sampled_softmax_loss(*map(torch.from_numpy,
                                       (x, table, labels, sids)), cap=cap)
    jx = tuple(map(jnp.asarray, (x, table, labels, sids)))
    lk = jax_sampled_pallas(*jx, cap=cap, interpret=True)
    lr = jref.sampled_softmax_loss_ref(*jx, cap=cap)
    assert lt.dtype == torch.float32 and lt.dim() == 0
    for want in (lk, lr):
        assert abs(float(lt) - float(want)) <= 1e-5 * abs(float(want))


def _loss_inputs(dt, B=2, S=8, n=16):
    jcfg = dataclasses.replace(jax_get_config("glm4_9b", smoke=True),
                               vocab_size=250)
    tcfg = dataclasses.replace(get_config("glm4_9b", smoke=True),
                               vocab_size=250)
    V, d = tcfg.padded_vocab_size, tcfg.d_model
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (B, S, d)).astype(np.float32)
    table = (rng.normal(0, 1, (V, d)) / np.sqrt(d)).astype(np.float32)
    labels = rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    sids = rng.choice(tcfg.vocab_size, n, replace=False).astype(np.int32)
    labels[0, :2] = sids[:2]                        # accidental hits
    jx = [jnp.asarray(x).astype(JD[dt]), jnp.asarray(table).astype(JD[dt])]
    tx = [torch.from_numpy(x).to(TD[dt]).requires_grad_(),
          torch.from_numpy(table).to(TD[dt]).requires_grad_()]
    return jcfg, tcfg, jx, tx, labels, sids


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [4096, 4])
def test_lm_loss_matches_jax(mesh, dt, chunk):
    """Value and gradients (x and table) of the chunked vocab-masked
    cross-entropy; chunk 4 takes the 16 tokens in 4 chunks."""
    jcfg, tcfg, (jxv, jt), (txv, tt), labels, _ = _loss_inputs(dt)
    with jax.set_mesh(mesh):
        jl, jg = jax.value_and_grad(
            lambda x, t: jemb.lm_loss(x, t, jnp.asarray(labels), jcfg,
                                      chunk=chunk), (0, 1))(jxv, jt)
    tl = temb.lm_loss(txv, tt, torch.from_numpy(labels), tcfg, chunk=chunk)
    tl.backward()
    assert tl.dtype == torch.float32
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    for t, g in zip((txv, tt), jg):
        assert t.grad.dtype == TD[dt]
        _close(t.grad, g, GRAD_TOL[dt])
    assert float(tt.grad[tcfg.vocab_size:].abs().max()) == 0.0   # padding


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_model_sampled_softmax_matches_jax(mesh, dt):
    jcfg, tcfg, (jxv, jt), (txv, tt), labels, sids = _loss_inputs(dt)
    with jax.set_mesh(mesh):
        jl, jg = jax.value_and_grad(
            lambda x, t: jemb.sampled_softmax_loss(
                x, t, jnp.asarray(labels), jnp.asarray(sids), jcfg),
            (0, 1))(jxv, jt)
    tl = temb.sampled_softmax_loss(txv, tt, torch.from_numpy(labels),
                                   torch.from_numpy(sids), tcfg)
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    for t, g in zip((txv, tt), jg):
        _close(t.grad, g, GRAD_TOL[dt])
    # the kernel op's plain version computes the same loss
    d = tcfg.d_model
    op = ops.sampled_softmax_loss(txv.detach().reshape(-1, d), tt.detach(),
                                  torch.from_numpy(labels).reshape(-1),
                                  torch.from_numpy(sids))
    tl = float(tl.detach())
    assert abs(float(op) - tl) <= 1e-5 * abs(tl)


def test_kernel_wrapper_refuses_before_launch():
    x = torch.zeros((8, 64), dtype=torch.bfloat16)
    table = torch.zeros((32, 64), dtype=torch.bfloat16)
    lab = torch.zeros(8, dtype=torch.int32)
    sids = torch.arange(4, dtype=torch.int32)
    before = tss.sampled_softmax_loss.launches
    with pytest.raises(ValueError, match="bf16"):
        tss.sampled_softmax_loss(x.float(), table, lab, sids)
    with pytest.raises(ValueError, match="multiple of 64"):
        tss.sampled_softmax_loss(x[:, :48], table[:, :48], lab, sids)
    with pytest.raises(ValueError, match="labels"):
        tss.sampled_softmax_loss(x, table, lab[:4], sids)
    with pytest.raises(ValueError, match="CUDA"):
        tss.sampled_softmax_loss(x, table, lab, sids)
    assert tss.sampled_softmax_loss.launches == before


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("n", [1, 64, 200, 8000, 8192])
@pytest.mark.parametrize("T", [1, 100, 4095, 4096])
def test_launch_plan(T, n, sms):
    """The GEMM launch's plan: every 256-column tile in exactly one range,
    the ranges ascending (the order the row's partials merge in) and none
    empty, every (row tile, range) block once with row tiles fastest, no
    second wave of blocks, and the same plan on a repeat call."""
    p = tss.plan(T, n, sms)
    assert p == tss.plan(T, n, sms)
    assert p.row_tiles == -(-T // 128) and p.n_tiles == -(-n // 256)
    ranges = p.ranges()
    assert len(ranges) == p.nsplit >= 1
    assert [t for lo, hi in ranges for t in range(lo, hi)] == \
        list(range(p.n_tiles))
    assert all(lo < hi for lo, hi in ranges)
    assert all(hi == lo2 for (_, hi), (lo2, _) in zip(ranges, ranges[1:]))
    assert p.blocks() == [(rt, s) for s in range(p.nsplit)
                          for rt in range(p.row_tiles)]
    assert p.row_tiles * p.nsplit <= max(sms, p.row_tiles)
    if (T, n, sms) == (4096, 8192, 132):          # glm4's head on an H100
        assert (p.row_tiles, p.nsplit, p.per) == (32, 4, 8)

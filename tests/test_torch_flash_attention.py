"""The port's flash attention against the JAX package, on
``tests/test_kernels.py``'s attention cases.

On the CPU the port attends with ``dense_attention`` (the JAX package's
plain path); the flash kernel's plain version is
``ref.flash_attention_fwd_plain`` (o, lse) and its backward
``ref.flash_attention_bwd_plain``, the port of the custom VJP's
``_bwd_ref``. Each is held against the JAX function: the Pallas kernel in
interpret mode for the forward and ``jax.vjp`` through it for the
backward. Tolerances, relative to each tensor's largest magnitude: 1e-5
in fp32 (the frameworks sum in other orders) and 1e-2 in bf16 (one
rounding of the outputs apart). The kernel itself runs only on a card
(``tests/test_torch_training_cuda.py`` and ``chip_smoke.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.models import attention as jatt
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tatt
import torch_cpu  # noqa: F401  (one torch thread)

TOL = {"float32": 1e-5, "bfloat16": 1e-2}
JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# B, Sq, Skv, H, K, hd, causal, window, cap, dtype (test_kernels.py)
ATTN_CASES = [
    (2, 256, 256, 4, 2, 64, True, None, None, "bfloat16"),
    (1, 128, 384, 4, 4, 128, True, None, 50.0, "float32"),
    (2, 256, 256, 8, 2, 64, True, 64, None, "bfloat16"),
    (1, 200, 200, 2, 1, 64, False, None, None, "float32"),
    (1, 64, 512, 6, 2, 32, True, 128, 30.0, "float32"),
]


def _inputs(case):
    B, Sq, Skv, H, K, hd, causal, window, cap, dt = case
    rng = np.random.default_rng(ATTN_CASES.index(case))
    shapes = ((B, Sq, H, hd), (B, Skv, K, hd), (B, Skv, K, hd),
              (B, Sq, H, hd))
    arrs = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    jx = [jnp.asarray(a).astype(JD[dt]) for a in arrs]
    tx = [torch.from_numpy(a).to(TD[dt]) for a in arrs]
    return jx, tx, dict(causal=causal, window=window, cap=cap)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(x, np.float32)


def _close(a, b, dt):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape
    err = float(np.abs(a - b).max())
    assert err <= TOL[dt] * max(float(np.abs(b).max()), 1e-30), err


def _jax_flash(jq, jk, jv, opts):
    return jfa.flash_attention(jq, jk, jv, opts["causal"], opts["window"],
                               opts["cap"], None, 0, 128, 128, True)


@pytest.mark.parametrize("case", ATTN_CASES)
def test_forward_matches_jax(case):
    """dense_attention vs JAX dense_attention; the plain (o, lse) vs the
    Pallas kernel in interpret mode (o and its fp32 lse)."""
    dt = case[-1]
    (jq, jk, jv, _), (tq, tk, tv, _), opts = _inputs(case)
    _close(tatt.dense_attention(tq, tk, tv, **opts),
           jatt.dense_attention(jq, jk, jv, **opts), dt)
    _close(ops.flash_attention(tq, tk, tv, **opts),
           jatt.dense_attention(jq, jk, jv, **opts), dt)
    scale = case[5] ** -0.5
    jo, jlse = jfa._flash_fwd(jq, jk, jv, scale=scale, q_offset=0,
                              block_q=128, block_kv=128, interpret=True,
                              **opts)
    to, tlse = tref.flash_attention_fwd_plain(tq, tk, tv, **opts)
    _close(to, jo, dt)
    _close(tlse, jlse, "float32")


@pytest.mark.parametrize("case", ATTN_CASES)
def test_backward_matches_jax_vjp(case):
    """flash_attention_bwd_plain from the JAX kernel's own residuals vs
    jax.vjp through the interpret-mode kernel (its custom VJP)."""
    dt = case[-1]
    (jq, jk, jv, jdo), (tq, tk, tv, tdo), opts = _inputs(case)
    scale = case[5] ** -0.5
    jo, jlse = jfa._flash_fwd(jq, jk, jv, scale=scale, q_offset=0,
                              block_q=128, block_kv=128, interpret=True,
                              **opts)
    _, vjp = jax.vjp(lambda q, k, v: _jax_flash(q, k, v, opts), jq, jk, jv)
    jgrads = vjp(jdo)
    to = torch.from_numpy(_np(jo)).to(TD[dt])
    tlse = torch.from_numpy(_np(jlse))
    tgrads = tref.flash_attention_bwd_plain(tq, tk, tv, to, tlse, tdo,
                                            **opts)
    for a, b in zip(tgrads, jgrads):
        assert a.dtype == TD[dt]
        _close(a, b, dt)
    # blocking over query rows changes only the order of dk/dv's sums
    blocked = tref.flash_attention_bwd_plain(tq, tk, tv, to, tlse, tdo,
                                             block_q=48, **opts)
    for a, b in zip(blocked, tgrads):
        _close(a, b, dt)


@pytest.mark.parametrize("case", ATTN_CASES)
def test_dense_attention_grads_match_jax(case):
    """Torch autograd through the port's dense_attention (the CPU path of
    training) vs jax.grad through the JAX package's."""
    dt = case[-1]
    (jq, jk, jv, jdo), (tq, tk, tv, tdo), opts = _inputs(case)
    _, vjp = jax.vjp(lambda q, k, v: jatt.dense_attention(q, k, v, **opts),
                     jq, jk, jv)
    jgrads = vjp(jdo)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    ops.flash_attention(*leaves, **opts).backward(tdo)
    for t, b in zip(leaves, jgrads):
        _close(t.grad, b, dt)


def test_q_offset_and_long_context_refusal():
    """q_offset shifts the causal diagonal as in the JAX path; beyond
    DENSE_ATTN_MAX_KV keys the CPU path streams (chunked_attention), where
    it once refused, and gives dense_attention's values."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(0, 1, s).astype(np.float32)
               for s in ((1, 16, 4, 16), (1, 48, 2, 16), (1, 48, 2, 16)))
    opts = dict(causal=True, window=8, cap=None, q_offset=32)
    _close(tatt.dense_attention(*map(torch.from_numpy, (q, k, v)), **opts),
           jatt.dense_attention(*map(jnp.asarray, (q, k, v)), **opts),
           "float32")
    to, tlse = tref.flash_attention_fwd_plain(
        *map(torch.from_numpy, (q, k, v)), **opts)
    jo, jlse = jfa._flash_fwd(*map(jnp.asarray, (q, k, v)), scale=0.25,
                              block_q=128, block_kv=128, interpret=True,
                              **opts)
    _close(to, jo, "float32")
    _close(tlse, jlse, "float32")
    big = torch.from_numpy(rng.normal(
        0, 1, (1, ops.DENSE_ATTN_MAX_KV + 1, 1, 16)).astype(np.float32))
    got = ops.flash_attention(big[:, :1], big, big, q_offset=4000)
    want = tatt.dense_attention(big[:, :1], big, big, q_offset=4000)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_kernel_wrapper_refuses_before_launch():
    """What the kernel does not take raises ValueError naming it, before
    any launch (CPU tensors here, so the device check comes last)."""
    q = torch.zeros((1, 8, 4, 128), dtype=torch.bfloat16)
    kv = torch.zeros((1, 8, 2, 128), dtype=torch.bfloat16)
    before = dict(tfa.flash_attention.launches)
    with pytest.raises(ValueError, match="bf16"):
        tfa.flash_attention(q.float(), kv, kv)
    with pytest.raises(ValueError, match="head dims"):
        tfa.flash_attention(q[..., :48], kv[..., :48], kv[..., :48])
    with pytest.raises(ValueError, match="no keys"):
        tfa.flash_attention(q, kv[:, :0], kv[:, :0])
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, kv, kv)
    assert dict(tfa.flash_attention.launches) == before


@pytest.mark.parametrize("hd,route", [(128, "wgmma"), (16, "mma"),
                                      (64, "wgmma64"), (80, "wgmma80"),
                                      (8, "mma"), (12, "mma")])
def test_kernel_routes_by_head_dim(hd, route):
    """hd 128, 80 and 64 go to the Hopper kernel's instances (TMA +
    wgmma), hd 8, 12 and 16 to the mma.sync kernel's (16-value rows, the
    columns past hd zero); a CPU tensor of any of them is refused before
    the launch, and no route's counter moves."""
    assert tfa.route(hd) == route
    q = torch.zeros((1, 8, 4, hd), dtype=torch.bfloat16)
    kv = torch.zeros((1, 8, 2, hd), dtype=torch.bfloat16)
    before = dict(tfa.flash_attention.launches)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.FlashAttention.apply(q, kv, kv, True, None, None, None, 0)
    assert dict(tfa.flash_attention.launches) == before


@pytest.mark.parametrize("hd", [32, 48, 96, 256])
def test_kernel_refuses_other_head_dims_by_name(hd):
    """Every head dim but 8, 12, 16, 64, 80 and 128 is refused by name (no
    route takes it, and nothing falls back), before any route's counter
    moves."""
    with pytest.raises(ValueError,
                       match=r"head dims \(8, 12, 16, 64, 80, 128\)"):
        tfa.route(hd)
    q = torch.zeros((1, 8, 4, hd), dtype=torch.bfloat16)
    kv = torch.zeros((1, 8, 2, hd), dtype=torch.bfloat16)
    before = dict(tfa.flash_attention.launches)
    with pytest.raises(ValueError, match="head dims"):
        tfa.flash_attention(q, kv, kv)
    assert dict(tfa.flash_attention.launches) == before

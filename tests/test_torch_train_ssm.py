"""Training of Mamba2 (mamba2_370m) and the hybrid (zamba2_2p7b) in the
port against the JAX package at smoke size (``torch_train_cases``): the
loss, one AdamW step and one fp32 SGD step's masters. On the CPU the SSD
scan is ``ssd_chunked`` under autograd, as the JAX package's plain path
differentiates it; on the card it runs the kernel under ``SSD``, whose
backward recomputes ``ssd_chunked`` from the saved inputs: here the
kernel is stood in by its plain version, so the Function's backward runs
and must give autograd's gradients bit for bit."""

import numpy as np
import pytest
import torch

from torch_train_cases import (cases as make_cases, check_loss_fn,
                               check_sgd_masters, check_train_step)
from repro_torch.kernels import ssd as tssd
from repro_torch.models.ssm import ssd_chunked
import torch_cpu  # noqa: F401  (one torch thread)

ARCHS = ["mamba2_370m", "zamba2_2p7b"]


@pytest.fixture(scope="module")
def cases():
    return make_cases(ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_jax(cases, arch):
    check_loss_fn(cases[arch, "bfloat16"])


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(cases, arch):
    check_train_step(cases[arch, "bfloat16"])


@pytest.mark.parametrize("arch", ARCHS)
def test_sgd_masters_match_jax(cases, arch):
    check_sgd_masters(cases[arch, "float32"])


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_function_backward_is_the_plain_gradient(monkeypatch, with_h0):
    """``SSD`` with the kernel stood in by ``ssd_chunked``: every input's
    gradient (x, dt, A, B, C, and h0 when given) equals autograd through
    ``ssd_chunked`` bit for bit, for a loss on both outputs and on y
    alone; inputs that need no gradient get none; the forward launches
    once."""
    def plain(x, dt, A, B, C, *, chunk, h0=None):
        plain.launches += 1
        return ssd_chunked(x, dt, A, B, C, chunk=chunk, h0=h0)

    plain.launches = 0
    monkeypatch.setattr(tssd, "ssd", plain)
    rng = np.random.default_rng(3)
    b, L, nh, hp, G, N = 2, 32, 4, 8, 2, 8

    def leaf(shape, dtype):
        return torch.from_numpy(rng.normal(0, 1, shape).astype(
            np.float32)).to(dtype)

    x = leaf((b, L, nh, hp), torch.bfloat16)
    dt = leaf((b, L, nh), torch.float32).abs() * 0.1
    A = -leaf((nh,), torch.float32).abs()
    Bm, Cm = (leaf((b, L, G, N), torch.bfloat16) for _ in range(2))
    h0 = leaf((b, nh, hp, N), torch.float32) if with_h0 else None
    ins = [x, dt, A, Bm, Cm] + ([h0] if with_h0 else [])
    for y_only in (False, True):
        grads = []
        for fn in ("function", "plain"):
            leaves = [t.clone().requires_grad_() for t in ins]
            args = leaves + ([] if with_h0 else [None])
            if fn == "function":
                y, h = tssd.SSD.apply(*args, 8)
            else:
                y, h = ssd_chunked(*args[:5], chunk=8, h0=args[5])
            loss = y.float().square().sum()
            if not y_only:
                loss = loss + (h * h.detach()).sum()
            loss.backward()
            grads.append([t.grad for t in leaves])
        for a, c in zip(*grads):
            assert a is not None and torch.equal(a, c)
    assert plain.launches == 2
    # only dt needs a gradient: it gets autograd's, nothing else is asked
    dtl = dt.clone().requires_grad_()
    y, _ = tssd.SSD.apply(x, dtl, A, Bm, Cm, h0, 8)
    g_fn, = torch.autograd.grad(y.float().sum(), [dtl])
    dtp = dt.clone().requires_grad_()
    y, _ = ssd_chunked(x, dtp, A, Bm, Cm, chunk=8, h0=h0)
    g_plain, = torch.autograd.grad(y.float().sum(), [dtp])
    assert torch.equal(g_fn, g_plain)

"""The SSD scan kernel on the card against its plain version
(``models.ssm.ssd_chunked``), with its two bitwise invariants and its
strided B/C inputs, and the ``SSD`` autograd function (the kernel
forward, the plain recompute backward) against autograd through the
plain scan. Every test skips without a CUDA card. The file imports
neither jax nor the JAX package (the CPU tests of the scan, against the
JAX package, are in ``test_torch_ssm.py``), so on a machine with a card
and without jax it runs alone:

  PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_ssm_cuda.py

Tolerances, kernel against plain: every y row (one head's hp values)
within 1e-2 of its norm (y is bf16); h_last within 1e-3 absolute and
relative (the kernel's fp32 operands enter the tensor cores as bf16 hi +
lo parts, about 16 bits).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ssd as ssd_k
from repro_torch.models import ssm as tssm

CASES = [  # (b, S, nh, hp, G, N, Q)
    (2, 64, 4, 16, 1, 16, 16),
    (1, 128, 8, 64, 1, 64, 32),
    (2, 96, 4, 32, 2, 16, 16),
    (2, 16, 4, 16, 1, 16, 8),          # Q not a multiple of 16
    (2, 512, 32, 64, 1, 128, 256),     # mamba2_370m's widths, S = 2Q
    (1, 512, 80, 64, 1, 64, 256),      # zamba2_2p7b's widths, S = 2Q
]


def _inputs(seed, b, S, nh, hp, G, N):
    """x, B, C ~ N(0, 1) in bf16, dt ~ U(0.001, 0.1), A ~ -U(0.5, 4),
    h0 ~ N(0, 0.5^2), on the card."""
    rng = np.random.default_rng(seed)
    arrays = (rng.normal(0, 1, (b, S, nh, hp)),
              rng.uniform(0.001, 0.1, (b, S, nh)),
              -rng.uniform(0.5, 4, (nh,)),
              rng.normal(0, 1, (b, S, G, N)),
              rng.normal(0, 1, (b, S, G, N)),
              0.5 * rng.normal(0, 1, (b, nh, hp, N)))
    x, dt, A, B, C, h0 = (torch.tensor(a, dtype=torch.float32,
                                       device="cuda") for a in arrays)
    return x.bfloat16(), dt, A, B.bfloat16(), C.bfloat16(), h0


def _check_close(y_k, h_k, y_p, h_p):
    a, r = y_k.float().flatten(0, -2), y_p.float().flatten(0, -2)
    rel = torch.nan_to_num((a - r).norm(dim=-1) / r.norm(dim=-1), nan=0.0)
    assert float(rel.max()) <= 1e-2
    torch.testing.assert_close(h_k, h_p, atol=1e-3, rtol=1e-3)


def _rows(t, lo, hi):
    return t[:, lo:hi].contiguous()


@pytest.mark.parametrize("case", CASES)
def test_cuda_ssd_kernel_vs_plain(case):
    """Kernel vs plain; two launches of Q with the state carried == one
    launch of 2Q; rows with dt = 0 past row n leave h_last and the first n
    rows' y unchanged whatever x, B and C they hold, and a whole chunk of
    them is the identity on the state; B and C as strided slices of one
    wider tensor give the same bits as contiguous copies. Bitwise checks
    are exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    b, S, nh, hp, G, N, Q = case
    x, dt, A, B, C, h0 = _inputs(1, b, S, nh, hp, G, N)
    y_k, h_k = ssd_k.ssd(x, dt, A, B, C, chunk=Q, h0=h0)
    _check_close(y_k, h_k, *tssm.ssd_chunked(x, dt, A, B, C, Q, h0=h0))

    # one launch over S rows == launches of Q rows with the state carried
    ys, hc = [], h0
    for lo in range(0, S, Q):
        yc, hc = ssd_k.ssd(*(_rows(t, lo, lo + Q) for t in (x, dt)), A,
                           *(_rows(t, lo, lo + Q) for t in (B, C)),
                           chunk=Q, h0=hc)
        ys.append(yc)
    assert torch.equal(torch.cat(ys, dim=1), y_k)
    assert torch.equal(hc, h_k)

    # dt = 0 from row n on (inside the first chunk): other x, B, C there
    # change nothing
    n = Q // 2 + 3 if Q > 8 else 5
    dt0 = dt.clone()
    dt0[:, n:] = 0.0
    x2, _, _, B2, C2, _ = _inputs(2, b, S, nh, hp, G, N)
    for t, t2 in ((x, x2), (B, B2), (C, C2)):
        t2[:, :n] = t[:, :n]
    y1, h1 = ssd_k.ssd(x, dt0, A, B, C, chunk=Q, h0=h0)
    y2, h2 = ssd_k.ssd(x2, dt0, A, B2, C2, chunk=Q, h0=h0)
    assert torch.equal(h1, h2)
    assert torch.equal(y1[:, :n], y2[:, :n])
    # the chunks after the first are all dt = 0: the state after the first
    # chunk is h_last, and the first chunk's y is unchanged
    yq, hq = ssd_k.ssd(*(_rows(t, 0, Q) for t in (x, dt0)), A,
                       *(_rows(t, 0, Q) for t in (B, C)), chunk=Q, h0=h0)
    assert torch.equal(hq, h1)
    assert torch.equal(yq, y1[:, :Q])

    # B and C as slices of one (b, S, 2 G N) tensor, as the model passes
    # them: strided rows, the same bits as contiguous copies
    bc = torch.cat([B.flatten(2), C.flatten(2)], dim=-1)
    Bs = bc[..., :G * N].unflatten(-1, (G, N))
    Cs = bc[..., G * N:].unflatten(-1, (G, N))
    assert not Bs.is_contiguous()
    y_s, h_s = ops.ssd(x, dt, A, Bs, Cs, chunk=Q, h0=h0)
    assert torch.equal(y_s, y_k)
    assert torch.equal(h_s, h_k)


def test_cuda_ssd_kernel_without_h0_and_empty():
    """h0 = None starts from zeros (the same bits as explicit zeros); S = 0
    returns h0 (or zeros) as h_last."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    x, dt, A, B, C, h0 = _inputs(3, 2, 64, 4, 32, 2, 16)
    y0, h0k = ssd_k.ssd(x, dt, A, B, C, chunk=32)
    yz, hz = ssd_k.ssd(x, dt, A, B, C, chunk=32, h0=torch.zeros_like(h0))
    _check_close(y0, h0k, *tssm.ssd_chunked(x, dt, A, B, C, 32))
    assert torch.equal(hz, h0k) and torch.equal(yz, y0)
    e = slice(0, 0)
    _, h_e = ssd_k.ssd(x[:, e], dt[:, e], A, B[:, e], C[:, e], chunk=32,
                       h0=h0)
    assert torch.equal(h_e, h0)
    _, h_e = ssd_k.ssd(x[:, e], dt[:, e], A, B[:, e], C[:, e], chunk=32)
    assert torch.equal(h_e, torch.zeros_like(h0))


@pytest.mark.parametrize("case", [CASES[0], CASES[2], CASES[4]])
def test_cuda_ssd_function_gradients_vs_plain(case):
    """``SSD``'s gradients for x, dt, A, B, C and h0 against autograd
    through ``ssd_chunked`` on the same inputs and output gradients:
    every gradient row (last dim) within 1e-2 of its norm; the forward
    launches the kernel once, the backward never."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    b, S, nh, hp, G, N, Q = case
    ins = _inputs(4, b, S, nh, hp, G, N)
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    gy = torch.randn((b, S, nh, hp), generator=g, device="cuda")
    gh = torch.randn((b, nh, hp, N), generator=g, device="cuda")
    grads = []
    for fn in ("kernel", "plain"):
        leaves = [t.clone().requires_grad_() for t in ins]
        before = ssd_k.ssd.launches
        if fn == "kernel":
            y, h = ssd_k.SSD.apply(*leaves, Q)
        else:
            y, h = tssm.ssd_chunked(*leaves[:5], Q, h0=leaves[5])
        ((y.float() * gy).sum() + (h * gh).sum()).backward()
        assert ssd_k.ssd.launches == before + (fn == "kernel")
        grads.append([t.grad.float() for t in leaves])
    for a, r in zip(*grads):
        a, r = a.reshape(-1, a.shape[-1]), r.reshape(-1, r.shape[-1])
        rel = torch.nan_to_num((a - r).norm(dim=-1) / r.norm(dim=-1),
                               nan=0.0)
        assert float(rel.max()) <= 1e-2

"""The port's mixture-of-experts block against the JAX package's, on the
CPU at both MoE smoke configs (qwen3-moe: 8 experts top-2; grok-1: 4
experts top-2, GeGLU).

``moe_block`` against the JAX ``moe_block`` under a one-device mesh (its
mode "tp": every expert local) in fp32 at 1e-5 of the output's largest
value, at capacity factors 1.25 (the default), 16 (no drops) and 0.01
(C = 8, the floor: drops), where the same assignments are dropped and
the same rows come out zero; in bf16 at 1e-2. The routing pieces
(``_route``, ``_positions_in_expert``, the load-balance loss) equal the
reference's, a planted top-k tie picks the lower expert id as
``jax.lax.top_k`` does, and zero padding rows at the end of a batch route
and take capacity as in the reference (they are dropped first)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jax_get_config
from repro.models import api as japi
from repro.models import moe as jmoe
from repro_torch.config import get_config
from repro_torch.models import moe
import torch_cpu  # noqa: F401  (one torch thread)

ARCHS = ["qwen3_moe_30b_a3b", "grok1_314b"]
FP32_TOL = 1e-5
BF16_TOL = 1e-2


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _cfgs(arch, cf=None):
    jc, tc = jax_get_config(arch, smoke=True), get_config(arch, smoke=True)
    if cf is not None:
        jc = dataclasses.replace(
            jc, moe=dataclasses.replace(jc.moe, capacity_factor=cf))
        tc = dataclasses.replace(
            tc, moe=dataclasses.replace(tc.moe, capacity_factor=cf))
    return jc, tc


def _moe_params(mesh, arch):
    """Layer 0's fp32 moe leaves of the JAX package's init (numpy)."""
    with jax.set_mesh(mesh):
        pf, _ = japi.init_model(jax_get_config(arch, smoke=True),
                                jax.random.key(0))
    return {k: np.array(v[0])
            for k, v in pf["blocks"]["sub0"]["moe"].items()}


def _both(mesh, jc, tc, p, x, dtype):
    """(JAX y, aux), (port y, aux) as numpy / floats on the same inputs.
    The port's block returns y; its aux is ``_aux_loss`` of its routing of
    the same rows (the reference's ``moe_block`` computes it so)."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    with jax.set_mesh(mesh):
        yj, aj = jmoe.moe_block({k: jnp.asarray(v, jdt) for k, v in
                                 p.items()}, jnp.asarray(x, jdt), jc)
    xt = torch.from_numpy(x).to(tdt)
    yt = moe.moe_block({k: torch.from_numpy(v).to(tdt) for k, v in
                        p.items()}, xt, tc)
    _, idx, probs = moe._route(xt.reshape(-1, x.shape[-1]),
                               torch.from_numpy(p["router"]).to(tdt),
                               tc.moe.experts_per_token)
    at = moe._aux_loss(probs, idx, tc.moe.num_experts)
    return (np.asarray(yj.astype(jnp.float32)), float(aj)), \
        (yt.float().numpy(), float(at))


def _kept(idx, E, C):
    return np.asarray(jmoe._positions_in_expert(jnp.asarray(idx), E)) < C


@pytest.mark.parametrize("cf", [1.25, 16.0, 0.01])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_reference_fp32(mesh, arch, cf):
    jc, tc = _cfgs(arch, cf)
    p = _moe_params(mesh, arch)
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 12, jc.d_model)).astype(np.float32)
    (yj, aj), (yt, at) = _both(mesh, jc, tc, p, x, "float32")
    np.testing.assert_allclose(yt, yj, rtol=0,
                               atol=FP32_TOL * np.abs(yj).max())
    assert abs(at - aj) <= FP32_TOL * abs(aj)
    # the same assignments dropped: the same rows wholly zero, and at the
    # floor capacity some are dropped
    T, E, k = 24, tc.moe.num_experts, tc.moe.experts_per_token
    _, idx, _ = jmoe._route(jnp.asarray(x.reshape(T, -1)),
                            jnp.asarray(p["router"]), k)
    kept = _kept(idx, E, moe.capacity(tc, T))
    np.testing.assert_array_equal(np.abs(yt).sum(-1).reshape(-1) == 0,
                                  ~kept.any(-1))
    np.testing.assert_array_equal(np.abs(yj).sum(-1).reshape(-1) == 0,
                                  ~kept.any(-1))
    if cf == 0.01:
        assert not kept.all()
    if cf == 16.0:
        assert kept.all()


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_reference_bf16(mesh, arch):
    jc, tc = _cfgs(arch)
    p = _moe_params(mesh, arch)
    x = np.random.default_rng(1).normal(0, 1, (2, 12, jc.d_model)).astype(
        np.float32)
    (yj, aj), (yt, at) = _both(mesh, jc, tc, p, x, "bfloat16")
    np.testing.assert_allclose(yt, yj, rtol=0,
                               atol=BF16_TOL * np.abs(yj).max())
    assert abs(at - aj) <= BF16_TOL * abs(aj)


@pytest.mark.parametrize("arch", ARCHS)
def test_route_positions_and_aux_with_a_planted_tie(mesh, arch):
    """Two router columns made equal: the tied experts get equal
    probabilities on every token, and both packages take the lower id
    first. Weights, ids, probabilities, positions and the aux loss
    equal the reference's."""
    _, tc = _cfgs(arch)
    p = _moe_params(mesh, arch)
    E, k = tc.moe.num_experts, tc.moe.experts_per_token
    router = p["router"].copy()
    router[:, 2] = router[:, 1]
    x = np.random.default_rng(2).normal(0, 1, (40, tc.d_model)).astype(
        np.float32)
    wj, ij, pj = jmoe._route(jnp.asarray(x), jnp.asarray(router), k)
    wt, it, pt = moe._route(torch.from_numpy(x), torch.from_numpy(router),
                            k)
    ij = np.asarray(ij)
    np.testing.assert_array_equal(it.numpy(), ij)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=FP32_TOL)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=FP32_TOL)
    both = (ij == 1).any(-1) & (ij == 2).any(-1)
    assert both.any(), "no token routed to both tied experts"
    for row in ij[both]:
        assert list(row).index(1) < list(row).index(2)
    np.testing.assert_array_equal(
        moe._positions_in_expert(it, E).numpy(),
        np.asarray(jmoe._positions_in_expert(jnp.asarray(ij), E)))
    aux_j = float(jmoe._aux_loss(pj, jnp.asarray(ij), E))
    aux_t = float(moe._aux_loss(pt, it, E))
    assert abs(aux_t - aux_j) <= FP32_TOL * aux_j


def test_padding_rows_take_capacity(mesh):
    """Zero rows appended to a batch (a chunk's padding, idle decode
    slots) route and take capacity: they widen C through T and, being
    last, are dropped first. The port's block gives the reference's
    output on the padded batch, its real rows differ from the unpadded
    batch's where the capacity changed, and padding rows took slots."""
    arch = "grok1_314b"
    jc, tc = _cfgs(arch, 1.0)
    p = _moe_params(mesh, arch)
    rng = np.random.default_rng(3)
    real = rng.normal(0, 1, (1, 20, jc.d_model)).astype(np.float32)
    padded = np.concatenate([real, np.zeros((1, 12, jc.d_model),
                                            np.float32)], axis=1)
    (yj, _), (yt, _) = _both(mesh, jc, tc, p, padded, "float32")
    np.testing.assert_allclose(yt, yj, rtol=0,
                               atol=FP32_TOL * np.abs(yj).max())
    E, k = tc.moe.num_experts, tc.moe.experts_per_token
    C20, C32 = moe.capacity(tc, 20), moe.capacity(tc, 32)
    assert C32 > C20
    _, idx, _ = moe._route(torch.from_numpy(padded[0]),
                           torch.from_numpy(p["router"]), k)
    pos = moe._positions_in_expert(idx, E)
    assert bool((pos[20:] < C32).any())       # padding rows took slots
    (_, _), (y_real, _) = _both(mesh, jc, tc, p, real, "float32")
    assert not np.allclose(y_real[0], yt[0, :20])

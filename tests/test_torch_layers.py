"""Layer-by-layer equivalence of the PyTorch port with the JAX package:
norms, rope, MLPs, projections, embedding and logits, on the same numpy
inputs. Tolerances follow the repo's ladder: fp32 1e-5, bf16 1e-2."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jax_get_config
from repro.models import attention as jatt
from repro.models import embedding as jemb
from repro.models import layers as jlay
from repro_torch.config import get_config
from repro_torch.models import attention as tatt
from repro_torch.models import embedding as temb
from repro_torch.models import layers as tlay
import torch_cpu  # noqa: F401  (one torch thread)

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-2)}


def _pair(a, dtype):
    """The same numpy values as a jax array and a torch tensor of dtype."""
    jd, td, _ = DTYPES[dtype]
    return jnp.asarray(a, jnp.float32).astype(jd), \
        torch.from_numpy(np.asarray(a, np.float32)).to(td)


def _close(j, t, dtype):
    np.testing.assert_allclose(np.asarray(j, np.float32),
                               t.float().numpy(), atol=DTYPES[dtype][2],
                               rtol=DTYPES[dtype][2])


def _cfgs(**over):
    return (dataclasses.replace(jax_get_config("glm4_9b", smoke=True),
                                **over),
            dataclasses.replace(get_config("glm4_9b", smoke=True), **over))


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_norm(norm, dtype):
    rng = np.random.default_rng(0)
    jc, tc = _cfgs(norm=norm)
    x = rng.normal(0, 2, (3, 5, 64))
    scale, bias = rng.normal(1, 0.1, 64), rng.normal(0, 0.1, 64)
    xj, xt = _pair(x, dtype)
    pj = {"scale": jnp.asarray(scale, jnp.float32),
          "bias": jnp.asarray(bias, jnp.float32)}
    pt = {k: torch.from_numpy(np.asarray(v, np.float32))
          for k, v in (("scale", scale), ("bias", bias))}
    _close(jlay.apply_norm(pj, xj, jc), tlay.apply_norm(pt, xt, tc), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope(dtype):
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 4000, (2, 7)).astype(np.int32)
    cj, sj = jlay.rope_cos_sin(jnp.asarray(pos), 16, 10000.0)
    ct, st = tlay.rope_cos_sin(torch.from_numpy(pos), 16, 10000.0)
    np.testing.assert_allclose(np.asarray(cj), ct.numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(sj), st.numpy(), atol=1e-5)
    xj, xt = _pair(rng.normal(0, 1, (2, 7, 4, 16)), dtype)
    _close(jlay.apply_rope(xj, cj, sj), tlay.apply_rope(xt, ct, st), dtype)


@pytest.mark.parametrize("act", ["silu", "gelu", "gelu_mlp"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mlp(act, dtype):
    rng = np.random.default_rng(2)
    jc, tc = _cfgs(mlp_activation=act)
    names = ("w_in", "w_out") if act == "gelu_mlp" else \
        ("w_gate", "w_in", "w_out")
    shapes = {"w_gate": (64, 128), "w_in": (64, 128), "w_out": (128, 64)}
    w = {n: rng.normal(0, 0.125, shapes[n]) for n in names}
    pj = {n: _pair(v, dtype)[0] for n, v in w.items()}
    pt = {n: _pair(v, dtype)[1] for n, v in w.items()}
    xj, xt = _pair(rng.normal(0, 1, (2, 3, 64)), dtype)
    _close(jlay.apply_mlp(pj, xj, jc), tlay.apply_mlp(pt, xt, tc), dtype)


def test_softcap():
    x = np.linspace(-200, 200, 101)
    xj, xt = _pair(x, "float32")
    _close(jlay.softcap(xj, 30.0), tlay.softcap(xt, 30.0), "float32")
    assert tlay.softcap(xt, None) is xt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_projections(dtype):
    rng = np.random.default_rng(3)
    jc, tc = _cfgs()
    d, H, K, hd = 64, 4, 2, 16
    w = {"wq": rng.normal(0, 0.125, (d, H, hd)),
         "wk": rng.normal(0, 0.125, (d, K, hd)),
         "wv": rng.normal(0, 0.125, (d, K, hd)),
         "wo": rng.normal(0, 0.125, (H, hd, d))}
    pj = {n: _pair(v, dtype)[0] for n, v in w.items()}
    pt = {n: _pair(v, dtype)[1] for n, v in w.items()}
    xj, xt = _pair(rng.normal(0, 1, (2, 5, d)), dtype)
    pos = np.arange(10).reshape(2, 5).astype(np.int32) + 3
    csj = jlay.rope_cos_sin(jnp.asarray(pos), hd, 10000.0)
    cst = tlay.rope_cos_sin(torch.from_numpy(pos), hd, 10000.0)
    _close(jatt.project_q(pj, xj, jc, csj), tatt.project_q(pt, xt, tc, cst),
           dtype)
    for a, b in zip(jatt.project_kv(pj, xj, jc, csj),
                    tatt.project_kv(pt, xt, tc, cst)):
        _close(a, b, dtype)
    yj, yt = _pair(rng.normal(0, 1, (2, 5, H, hd)), dtype)
    _close(jatt.out_proj(pj, yj, yj.dtype), tatt.out_proj(pt, yt, yt.dtype),
           dtype)
    assert tatt.attention_scale(tc) == jatt.attention_scale(jc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_and_logits(mesh, dtype):
    rng = np.random.default_rng(4)
    jc, tc = _cfgs(dtype=dtype)
    V, d = tc.padded_vocab_size, tc.d_model
    table = rng.normal(0, 0.5, (V, d))
    head = rng.normal(0, 0.125, (V, d))
    tok = rng.integers(0, V, (3, 4)).astype(np.int32)
    tok[0, 1], tok[1, 2], tok[2, 3] = -2, V, V + 5      # out of range: zeros
    tj, tt = _pair(table, dtype)
    hj, ht = _pair(head, dtype)
    with jax.set_mesh(mesh):
        ej = jemb.embed(tj, jnp.asarray(tok), jc)
        x = ej[:, :1]
        lj = jemb.decode_logits(x, hj, jc)
        aj = jemb.decode_logits_argmax(x, hj, jc)
    et = temb.embed(tt, torch.from_numpy(tok), tc)
    assert et.dtype == DTYPES[dtype][1]
    assert (et[0, 1] == 0).all() and (et[1, 2] == 0).all()
    np.testing.assert_array_equal(np.asarray(ej, np.float32),
                                  et.float().numpy())      # a pure gather
    lt = temb.decode_logits(et[:, :1], ht, tc)
    assert lt.dtype == torch.float32 and lt.shape == (3, V)
    np.testing.assert_allclose(np.asarray(lj), lt.numpy(), atol=1e-4,
                               rtol=1e-5)
    assert (lt[:, tc.vocab_size:] == -1e30).all()
    np.testing.assert_array_equal(
        np.asarray(aj), temb.decode_logits_argmax(et[:, :1], ht, tc).numpy())

"""The port's embedding gather: its wrapper's refusals, and the plain path
against the JAX package's Pallas gather.

The CUDA kernel runs only on a card (``tests/test_torch_training_cuda.py``
and ``chip_smoke.py`` hold it against ``table[ids]`` bit for bit). Here the
wrapper must refuse what the kernel does not take before any launch, and
``ops.embedding_gather`` on CPU tensors (``table[ids]``) must equal the
Pallas gather in interpret mode exactly, the first and last rows of the
table and out-of-range ids included (jnp's rule: a negative id counts
from the end, then the row is clamped), and its gradient must equal
jax.grad of ``table[ids]``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import embedding as jemb_k
from repro_torch.kernels import embedding as temb_k
from repro_torch.kernels import ops
import torch_cpu  # noqa: F401  (one torch thread)


def _table(dtype=torch.bfloat16, V=40, d=64):
    return torch.zeros((V, d), dtype=dtype)


REFUSALS = [  # name, table, ids, message
    ("cpu tensors", _table(), torch.zeros(3, dtype=torch.int32), "CUDA"),
    ("int64 ids", _table(), torch.zeros(3, dtype=torch.int64), "int32"),
    ("float ids", _table(), torch.zeros(3), "int32"),
    ("rows of 6 bytes", _table(d=3), torch.zeros(3, dtype=torch.int32),
     "4-byte words"),
    ("rows of 10 bytes", _table(d=5), torch.zeros(3, dtype=torch.int32),
     "4-byte words"),
    ("1-D table", torch.zeros(64, dtype=torch.bfloat16),
     torch.zeros(3, dtype=torch.int32), "2-D"),
    ("transposed table", _table().t(), torch.zeros(3, dtype=torch.int32),
     "contiguous"),
]


@pytest.mark.parametrize("name,table,ids,msg", REFUSALS,
                         ids=[r[0] for r in REFUSALS])
def test_gather_wrapper_refuses_before_launch(name, table, ids, msg):
    """Each thing the kernel does not take raises ValueError naming it;
    the shape and type checks come before the device check, so on CPU
    tensors each is seen; the launch counter does not move."""
    before = temb_k.gather.launches
    with pytest.raises(ValueError, match=msg):
        temb_k.gather(table, ids)
    assert temb_k.gather.launches == before


def _out_of_range(V):
    """Ids outside [0, V): jnp counts a negative id from the end, then
    clamps."""
    return [-1, -7, V, V + 7, -V, -V - 1, -(2 ** 31), 2 ** 31 - 1]


def _edge_ids(rng, T, V):
    """T random ids in [0, V) with V - 1 and 0 first and last, and (for T
    >= 10) the out-of-range ids in between."""
    ids = rng.integers(0, V, (T,)).astype(np.int32)
    bad = _out_of_range(V)
    if T >= 2 + len(bad):
        ids[1:1 + len(bad)] = bad
    ids[0], ids[-1] = V - 1, 0
    return ids


@pytest.mark.parametrize("T", [1, 8, 256])
def test_gather_plain_vs_pallas_interpret_edge_ids(T):
    """``ops.embedding_gather`` on the CPU equals the Pallas gather
    (interpret mode) bit for bit, with ids 0 and V - 1 among the T ids,
    and at T = 256 ids >= V and < -V and negative ids in range."""
    rng = np.random.default_rng(T)
    V, d = 300, 32
    table = rng.normal(0, 1, (V, d)).astype(np.float32)
    ids = _edge_ids(rng, T, V)
    o_j = jemb_k.gather(jnp.asarray(table).astype(jnp.bfloat16),
                        jnp.asarray(ids), interpret=True)
    o_t = ops.embedding_gather(torch.from_numpy(table).bfloat16(),
                               torch.from_numpy(ids))
    assert o_t.shape == (T, d)
    np.testing.assert_array_equal(np.asarray(o_j, np.float32),
                                  o_t.float().numpy())


@pytest.mark.parametrize("T", [10, 256])
def test_gather_plain_grad_vs_jax_grad_out_of_range(T):
    """The plain gather's gradient in the table equals jax.grad of the
    reference ``table[ids]`` bit for bit, with ids >= V, < -V and
    negative in range among the ids (and repeats): a wrapped id in range
    scatters into its row, one still out of range adds nothing. The
    forward equals ``table[ids]`` too."""
    import jax
    rng = np.random.default_rng(100 + T)
    V, d = 40, 16
    table = rng.normal(0, 1, (V, d)).astype(np.float32)
    ids = _edge_ids(rng, T, V)
    w = rng.normal(0, 1, (T, d)).astype(np.float32)

    def loss_j(t):
        return (t[jnp.asarray(ids)] * jnp.asarray(w)).sum()

    g_j = jax.grad(loss_j)(jnp.asarray(table))
    tt = torch.from_numpy(table).requires_grad_()
    o_t = ops.embedding_gather(tt, torch.from_numpy(ids))
    (o_t * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(np.asarray(jnp.asarray(table)[ids]),
                                  o_t.detach().numpy())
    np.testing.assert_array_equal(np.asarray(g_j), tt.grad.numpy())

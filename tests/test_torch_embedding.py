"""The port's embedding gather: its wrapper's refusals, and the plain path
against the JAX package's Pallas gather.

The CUDA kernel runs only on a card (``tests/test_torch_training_cuda.py``
and ``chip_smoke.py`` hold it against ``table[ids]`` bit for bit). Here the
wrapper must refuse what the kernel does not take before any launch, and
``ops.embedding_gather`` on CPU tensors (``table[ids]``) must equal the
Pallas gather in interpret mode exactly, the first and last rows of the
table included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import embedding as jemb_k
from repro_torch.kernels import embedding as temb_k
from repro_torch.kernels import ops


def _table(dtype=torch.bfloat16, V=40, d=64):
    return torch.zeros((V, d), dtype=dtype)


REFUSALS = [  # name, table, ids, message
    ("cpu tensors", _table(), torch.zeros(3, dtype=torch.int32), "CUDA"),
    ("int64 ids", _table(), torch.zeros(3, dtype=torch.int64), "int32"),
    ("float ids", _table(), torch.zeros(3), "int32"),
    ("rows of 6 bytes", _table(d=3), torch.zeros(3, dtype=torch.int32),
     "16-byte"),
    ("rows of 20 bytes", _table(torch.float32, d=5),
     torch.zeros(3, dtype=torch.int32), "16-byte"),
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


@pytest.mark.parametrize("T", [1, 8, 256])
def test_gather_plain_vs_pallas_interpret_edge_ids(T):
    """``ops.embedding_gather`` on the CPU equals the Pallas gather
    (interpret mode) bit for bit, with ids 0 and V - 1 among the T ids."""
    rng = np.random.default_rng(T)
    V, d = 300, 32
    table = rng.normal(0, 1, (V, d)).astype(np.float32)
    ids = rng.integers(0, V, (T,)).astype(np.int32)
    ids[0], ids[-1] = V - 1, 0
    o_j = jemb_k.gather(jnp.asarray(table).astype(jnp.bfloat16),
                        jnp.asarray(ids), interpret=True)
    o_t = ops.embedding_gather(torch.from_numpy(table).bfloat16(),
                               torch.from_numpy(ids))
    assert o_t.shape == (T, d)
    np.testing.assert_array_equal(np.asarray(o_j, np.float32),
                                  o_t.float().numpy())

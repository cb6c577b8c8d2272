"""The port's plain sampling path: greedy equals the JAX package's exactly;
temperature/top-k keeps exactly the numpy oracle's support and matches
its distribution (TV distance + chi-square over many request ids); a
(seed, rid, counter) triple replays the same token, and its key is the
JAX package's ``_base_key`` (the streams are jax's own: the draws
themselves are held against jax in ``test_torch_prng.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving.sampling import _base_key as jax_base_key
from repro.serving.sampling import _prep_logits as jax_prep_logits
from repro.serving.sampling import sample_tokens as jax_sample_tokens
from repro_torch.serving.sampling import (NEG, base_key, prep_logits,
                                          sample_tokens)
import torch_cpu  # noqa: F401  (one torch thread)


def _oracle_probs(lg, t, k):
    """numpy: softmax(lg / t) restricted to the k largest (ties kept)."""
    z = lg / max(t, 1e-6)
    if k > 0:
        kth = np.sort(z)[len(z) - min(k, len(z))]
        z = np.where(z < kth, -np.inf, z)
    p = np.exp(z - z.max())
    return p / p.sum()


def test_greedy_matches_reference_exactly():
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 2, (9, 300)).astype(np.float32)
    logits[3, 10] = logits[3, 20] = 50.0          # a tie: first index wins
    zeros = np.zeros(9)
    ours = sample_tokens(torch.from_numpy(logits), zeros, zeros.astype(int),
                         zeros.astype(int), np.arange(9), zeros.astype(int))
    ref = jax_sample_tokens(jnp.asarray(logits), jnp.zeros(9),
                            jnp.zeros(9, jnp.int32), jnp.zeros(9, jnp.int32),
                            jnp.arange(9, dtype=jnp.int32),
                            jnp.zeros(9, jnp.int32))
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert int(ours[3]) == 10


@pytest.mark.parametrize("t,k", [(1.0, 0), (0.7, 5), (1.3, 1), (0.5, 40)])
def test_keep_mask_matches_oracle_and_reference(t, k):
    rng = np.random.default_rng(1)
    lg = rng.normal(0, 1.5, 40).astype(np.float32)
    ours = prep_logits(torch.from_numpy(lg), t, k).numpy()
    ref = np.asarray(jax_prep_logits(jnp.asarray(lg), t, k))
    keep = _oracle_probs(lg, t, k) > 0
    np.testing.assert_array_equal(ours > NEG / 2, keep)
    np.testing.assert_allclose(ours[keep], ref[keep], rtol=1e-6)


@pytest.mark.parametrize("t,k", [(0.9, 0), (1.2, 5)])
def test_sampled_distribution_matches_oracle(t, k):
    V, N = 12, 4000
    lg = np.random.default_rng(7).normal(0, 1.5, V).astype(np.float32)
    rows = torch.from_numpy(np.broadcast_to(lg, (N, V)).copy())
    toks = sample_tokens(rows, np.full(N, t), np.full(N, k), np.zeros(N, int),
                         np.arange(N), np.zeros(N, int)).numpy()
    obs = np.bincount(toks, minlength=V) / N
    want = _oracle_probs(lg, t, k)
    tv = 0.5 * np.abs(obs - want).sum()
    assert tv < 0.03, f"TV distance {tv:.4f}"
    support = want > 1e-9
    exp = want[support] * N
    chi2 = ((obs[support] * N - exp) ** 2 / exp).sum()
    df = int(support.sum()) - 1
    assert chi2 < df + 5 * np.sqrt(2 * df) + 10, f"chi2 {chi2:.1f} / {df}"
    assert obs[~support].sum() == 0.0


def test_stream_replays_by_seed_rid_counter():
    lg = torch.from_numpy(
        np.random.default_rng(2).normal(0, 1, (1, 500)).astype(np.float32))

    def draw(seed, rid, counter, t=1.0):
        return int(sample_tokens(lg, [t], [0], [seed], [rid], [counter])[0])

    assert draw(3, 17, 5) == draw(3, 17, 5)
    # different rid or counter: a different stream (compare several draws)
    a = [draw(3, 17, c) for c in range(8)]
    b = [draw(3, 18, c) for c in range(8)]
    assert a != b and len(set(a)) > 1
    # the key of a (seed, rid, counter) row is the reference's, word for
    # word, negative and wrapped int32 seeds included
    rows = [(3, 17, 5), (3, 17, 6), (4, 17, 5), (-1, 2 ** 20, 2 ** 20),
            (-(2 ** 31) + 5, 0, 7)]
    got = base_key(*(torch.tensor(c) for c in zip(*rows)))
    for (s, r, c), k in zip(rows, got.tolist()):
        want = jax.random.key_data(jax_base_key(jnp.int32(s), r, c))
        assert k == np.asarray(want).astype(np.int64).tolist(), (s, r, c)
    assert len({tuple(k) for k in got.tolist()}) == len(rows)
    # batch composition does not move a row's stream
    rows = lg.repeat(3, 1)
    toks = sample_tokens(rows, [1.0, 0.0, 1.0], [0, 0, 0], [3, 0, 9],
                         [17, 1, 2], [5, 0, 0])
    assert int(toks[0]) == draw(3, 17, 5)
    assert int(toks[1]) == int(lg[0].argmax())

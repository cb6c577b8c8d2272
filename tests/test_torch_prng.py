"""``repro_torch.serving.prng`` against ``jax.random`` on the CPU (jax's
default threefry generator, ``jax_threefry_partitionable`` on).

The hash, ``PRNGKey``, ``fold_in`` and ``random_bits`` are held bit for
bit, over the serving keys' whole range: seeds 0, 7, -1 and 2^31 + 5
wrapped into int32 (the JAX engine fills seeds as int32), rids and
counters up to 2^20, the speculative tags 1-3. ``uniform`` is bit for
bit too (no transcendental); the Gumbel noise within 1e-6 (``log``
rounds its last bit its own way); a categorical draw equals jax's except
where its top-2 score margin is below 1e-5."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax._src import prng as jax_prng
from repro_torch.serving import prng
import torch_cpu  # noqa: F401  (one torch thread)

SEEDS = (0, 7, -1, int(np.uint32(2 ** 31 + 5).view(np.int32)))
RIDS = (0, 5, 2 ** 20)
COUNTERS = (0, 3, 2 ** 20)
TAGS = (None, 1, 2, 3)
GUMBEL_TOL = 1e-6
TIE_TOL = 1e-5


def _jax_key(seed, rid, counter, tag=None):
    k = jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(jnp.int32(seed)), rid), counter)
    return k if tag is None else jax.random.fold_in(k, tag)


def _words(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


ROWS = list(itertools.product(SEEDS, RIDS, COUNTERS, TAGS))


def _torch_keys(rows):
    """The port's keys of (seed, rid, counter, tag) rows, one batch per
    tag (the tag is folded last, onto the base key)."""
    out = []
    for seed, rid, counter, tag in rows:
        k = prng.fold_in(prng.fold_in(prng.key(
            torch.tensor([seed], dtype=torch.int32)), rid), counter)
        out.append((k if tag is None else prng.fold_in(k, tag))[0])
    return torch.stack(out)


def test_threefry_matches_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    k = rng.integers(0, 2 ** 32, 2, dtype=np.uint64).astype(np.uint32)
    x = rng.integers(0, 2 ** 32, (2, 64), dtype=np.uint64).astype(np.uint32)
    want = jax_prng.threefry_2x32(jnp.asarray(k), jnp.asarray(x.ravel()))
    w = lambda a: torch.tensor(a.astype(np.int64))          # noqa: E731
    o0, o1 = prng.threefry2x32(w(k[0]), w(k[1]), w(x[0]), w(x[1]))
    np.testing.assert_array_equal(
        np.asarray(want).astype(np.int64),
        np.concatenate([o0.numpy(), o1.numpy()]))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_fold_in_match_jax(seed):
    """PRNGKey (negative and wrapped seeds included), then rid, counter
    and tag folds, batched over every (rid, counter, tag) row."""
    rows = [r for r in ROWS if r[0] == seed]
    got = _torch_keys(rows).numpy()
    want = np.stack([_words(_jax_key(*r)) for r in rows])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        prng.key(torch.tensor(seed, dtype=torch.int32)).numpy(),
        _words(jax.random.PRNGKey(jnp.int32(seed))))


@pytest.mark.parametrize("n", [1, 7, 1000])
def test_random_bits_match_jax(n):
    """(N, n) words from N keys in one call equal jax.random.bits of each
    key, row by row."""
    rows = ROWS[::5]
    got = prng.random_bits(_torch_keys(rows), n).numpy()
    for r, g in zip(rows, got):
        want = np.asarray(jax.random.bits(_jax_key(*r), (n,)))
        np.testing.assert_array_equal(g, want.astype(np.int64))


def test_uniform_and_gumbel_match_jax():
    rows = ROWS[::3]
    keys = _torch_keys(rows)
    u = prng.uniform(keys, 500).numpy()
    u1 = prng.uniform(keys, 1)[:, 0].numpy()
    g = prng.gumbel(keys, 500).numpy()
    for i, r in enumerate(rows):
        k = _jax_key(*r)
        np.testing.assert_array_equal(u[i],
                                      np.asarray(jax.random.uniform(k,
                                                                    (500,))))
        assert u1[i] == float(jax.random.uniform(k))
        np.testing.assert_allclose(g[i], np.asarray(jax.random.gumbel(
            k, (500,))), rtol=0, atol=GUMBEL_TOL)
    assert u.min() >= 0.0 and u.max() < 1.0


def test_categorical_matches_jax_except_near_ties():
    """40 rows of 512 logits under 40 keys: the draws equal jax's, except
    a row whose top-2 score (logits + noise) margin is below 1e-5."""
    rng = np.random.default_rng(1)
    rows = ROWS[:40]
    logits = rng.normal(0, 2, (40, 512)).astype(np.float32)
    keys = _torch_keys(rows)
    got = prng.categorical(keys, torch.from_numpy(logits)).numpy()
    score = prng.gumbel(keys, 512).numpy() + logits
    top2 = np.sort(score, axis=-1)[:, -2:]
    for i, r in enumerate(rows):
        want = int(jax.random.categorical(_jax_key(*r),
                                          jnp.asarray(logits[i])))
        if got[i] != want:
            assert top2[i, 1] - top2[i, 0] < TIE_TOL, (i, r)
    assert (got == np.array([int(jax.random.categorical(
        _jax_key(*r), jnp.asarray(logits[i]))) for i, r in
        enumerate(rows)])).mean() >= 0.95


def test_batched_keys_take_any_leading_shape():
    """(B, K, 2) keys give (B, K, n) bits equal to the flat batch's."""
    keys = _torch_keys(ROWS[:12])
    flat = prng.random_bits(keys, 33)
    np.testing.assert_array_equal(
        prng.random_bits(keys.reshape(3, 4, 2), 33).reshape(12, 33).numpy(),
        flat.numpy())
    assert prng.categorical(keys.reshape(3, 4, 2),
                            torch.zeros(3, 4, 9)).shape == (3, 4)

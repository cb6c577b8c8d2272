"""jax's counter-based random numbers as torch tensor functions.

The JAX package draws every sampled token from ``jax.random`` under the
default threefry generator with ``jax_threefry_partitionable`` on (jax
0.9's default). This module computes the same bits, so the port draws the
reference's own tokens on any device, and a draw is a pure function of
its key: it can be captured in a CUDA graph, and the card and the CPU
give the same bits.

- ``threefry2x32``: the Threefry-2x32 hash, 20 rounds (rotations 13, 15,
  26, 6 and 17, 29, 16, 24; key parity 0x1BD11BDA).
- ``key(seed)`` is ``PRNGKey(seed)`` of an int32 seed: the words (0, seed
  mod 2^32). ``fold_in(key, d)`` hashes the count pair (0, d).
- ``random_bits(key, n)``: index i of a flat shape enters as the pair
  (i >> 32, i & 0xffffffff), and its word is the xor of the hash's two
  outputs.
- ``uniform``, ``gumbel`` and ``categorical`` follow ``jax.random``'s
  float recipe: 23 random mantissa bits under the exponent of 1.0, minus
  1, scaled and clamped to the range; the Gumbel noise is
  ``-log(-log(u))`` over ``[tiny, 1)``; a categorical draw is the argmax
  of logits plus noise.

A key is an int64 tensor of shape (..., 2) holding two uint32 words.
Every function works on a batch of keys: a (N, 2) key tensor gives (N, n)
bits in one set of launches. The words are held in int64 and masked to
32 bits after every addition and shift. ``log`` may round its last bit
differently from XLA's, so Gumbel noise agrees with jax's within an ulp
or two, and a categorical draw can differ only at a near-tie.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["threefry2x32", "key", "fold_in", "random_bits", "uniform",
           "gumbel", "categorical"]

M32 = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA
TINY = float(np.finfo(np.float32).tiny)


def _word(x, device=None):
    """An integer tensor (or array) as int64 uint32 words."""
    return torch.as_tensor(x, device=device).to(torch.int64) & M32


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 of the count pairs (x0, x1) under the key (k0, k1):
    int64 tensors of uint32 words, broadcast together. Returns the two
    output words."""
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def key(seed, device=None):
    """``jax.random.PRNGKey`` of int32 seeds: (..., 2) words (0, seed mod
    2^32); a negative seed wraps, as the reference's int32 seed does."""
    s = _word(seed, device)
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def fold_in(k, data):
    """``jax.random.fold_in`` of (..., 2) keys and integer data (a tensor
    broadcast against the keys' batch shape, or an int, filled on the
    keys' device: no host-to-device copy, so a CUDA graph can capture
    it)."""
    if isinstance(data, int):
        d = torch.full(k.shape[:-1], data & M32, dtype=torch.int64,
                       device=k.device)
    else:
        d = _word(data, k.device)
    o0, o1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(o0, o1), dim=-1)


def random_bits(k, n: int):
    """``jax.random.bits`` of shape (n,) under each key: (..., n) int64
    words, index i hashed as the pair (i >> 32, i & 0xffffffff)."""
    i = torch.arange(n, dtype=torch.int64, device=k.device)
    b0, b1 = threefry2x32(k[..., 0, None], k[..., 1, None], i >> 32, i & M32)
    return b0 ^ b1


def _unit(bits):
    """[0, 1) floats from the top 23 bits of each word."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(k, n: int, minval: float = 0.0, maxval: float = 1.0):
    """``jax.random.uniform(key, (n,), float32, minval, maxval)`` under
    each key: (..., n) float32."""
    lo = np.float32(minval)
    span = np.float32(maxval) - lo                 # in float32, as jax
    u = _unit(random_bits(k, n)) * float(span) + float(lo)
    return torch.clamp_min(u, float(lo))


def gumbel(k, n: int):
    """``jax.random.gumbel(key, (n,), float32)`` (mode "low") under each
    key: (..., n) float32."""
    return -torch.log(-torch.log(uniform(k, n, TINY, 1.0)))


def categorical(k, logits):
    """``jax.random.categorical(key, logits)`` over the last axis: (...,)
    int64 indices, one per key and row."""
    return torch.argmax(gumbel(k, logits.shape[-1]) + logits, dim=-1)

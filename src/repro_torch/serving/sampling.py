"""Per-request token sampling (port of the plain path of
``repro.serving.sampling``).

Temperature 0 is exact greedy: argmax over the fp32 logits, no random
numbers. Otherwise the row is temperature-scaled and top-k-truncated
exactly as ``_prep_logits`` does in the JAX package, and one token is drawn
by the Gumbel-max trick (the method of ``jax.random.categorical``) from a
generator seeded by the triple ``(seed, rid, counter)``, counter being the
tokens the request has generated so far. A request's stream is thus a
pure function of (seed, rid, step): the same under any batch composition,
slot and preemption-recompute. On the card the generator is PyTorch's
Philox; on the CPU its Mersenne twister. The streams are not jax's
threefry streams, and the card's are not the CPU's: replay holds within
one device kind.

Not ported yet: the full pipeline (penalties, top-p, min-p, logprobs,
stop) and the speculative streams (ROADMAP.md queue 1 items 5 and 8).
"""

from __future__ import annotations

import numpy as np
import torch

NEG = -1.0e30
_MASK64 = (1 << 64) - 1


def _mix(x: int) -> int:
    """splitmix64 finaliser: spreads nearby integers over 64 bits."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def stream_seed(seed: int, rid: int, counter: int) -> int:
    """The generator seed of one (seed, rid, counter) draw."""
    h = _mix(int(seed) & _MASK64)
    h = _mix(h ^ (int(rid) & _MASK64))
    h = _mix(h ^ (int(counter) & _MASK64))
    return h >> 1                      # manual_seed takes a 63-bit value


def prep_logits(lg, t: float, k: int):
    """Temperature-scale + top-k-truncate one (V,) fp32 logit row."""
    V = lg.shape[-1]
    lg = lg / max(t, 1e-6)
    if k <= 0:
        return lg
    kth = torch.sort(lg).values[V - min(max(k, 1), V)]   # k-th largest
    return torch.where(lg < kth, NEG, lg)


def sample_tokens(logits, temps, top_ks, seeds, rids, counters):
    """logits: (B, V) fp32 tensor; temps/top_ks/seeds/rids/counters: (B,)
    host sequences (top_k 0 disables truncation). Returns (B,) int32 on
    logits' device."""
    out = torch.argmax(logits, dim=-1).to(torch.int32)
    draw_rows(logits, out, temps, top_ks, seeds, rids, counters)
    return out


def draw_rows(logits, out, temps, top_ks, seeds, rids, counters):
    """Overwrite ``out[i]`` (the greedy tokens) with a draw for every row
    whose temperature is above 0; greedy rows are left as they are. This
    is host work (a generator seeded per row), so the serving engine runs
    it after its compiled step, on the step's logits."""
    for i in np.flatnonzero(np.asarray(temps) > 0.0):
        lg = prep_logits(logits[i].float(), float(temps[i]), int(top_ks[i]))
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(stream_seed(seeds[i], rids[i], counters[i]))
        u = torch.rand(lg.shape, generator=gen, device=logits.device,
                       dtype=torch.float32)
        u = u.clamp(min=torch.finfo(torch.float32).tiny)
        out[i] = torch.argmax(lg - torch.log(-torch.log(u)))

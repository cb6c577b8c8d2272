"""Queue-fed input pipeline (port of ``repro.data.pipeline``, paper §3.2).

Producer threads synthesize batches into a bounded queue; the training
loop dequeues; a slow consumer stalls the producers, never the reverse.
``ShardedSource`` deals each data-parallel rank its disjoint slice of the
stream. Host side and numpy only: the same ``(seed, index, rank)`` gives
the JAX package's batches byte for byte.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from repro_torch.config import ModelConfig, ShapeConfig


class ShardedSource:
    """Deterministic synthetic token stream, sharded by data-parallel rank.

    Draws from a Zipfian unigram distribution with a simple Markov kick so
    models have structure to learn (loss decreases measurably).
    """

    def __init__(self, cfg: ModelConfig, seq_len: int, rank: int = 0,
                 world: int = 1, seed: int = 0):
        self.cfg = cfg
        self.seq_len = seq_len
        self.rank, self.world = rank, world
        self.seed = seed
        v = cfg.vocab_size
        r = np.random.default_rng(seed)
        probs = 1.0 / np.arange(1, v + 1) ** 1.1
        self.probs = probs / probs.sum()
        self.shift = r.integers(1, v)

    def batch(self, index: int, batch_size: int):
        """Global batch index -> this rank's examples."""
        rng = np.random.default_rng(
            (self.seed, index, self.rank))
        n = batch_size // self.world
        toks = rng.choice(self.cfg.vocab_size, size=(n, self.seq_len + 1),
                          p=self.probs).astype(np.int32)
        # Markov kick: half the positions continue deterministically
        cont = rng.random((n, self.seq_len)) < 0.5
        nxt = (toks[:, :-1] + self.shift) % self.cfg.vocab_size
        toks[:, 1:] = np.where(cont, nxt, toks[:, 1:])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class Pipeline:
    """Bounded prefetch queue with producer threads (backpressure)."""

    def __init__(self, source: ShardedSource, batch_size: int,
                 capacity: int = 4, producers: int = 1):
        self.source = source
        self.batch_size = batch_size
        self.q: queue.Queue = queue.Queue(maxsize=capacity)
        self._stop = threading.Event()
        self._next = 0
        self._lock = threading.Lock()
        self.threads = [threading.Thread(target=self._produce, daemon=True)
                        for _ in range(producers)]
        for t in self.threads:
            t.start()

    def _produce(self):
        while not self._stop.is_set():
            with self._lock:
                idx = self._next
                self._next += 1
            batch = self.source.batch(idx, self.batch_size)
            while not self._stop.is_set():
                try:
                    self.q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def get(self, timeout: float = 30.0):
        return self.q.get(timeout=timeout)

    def close(self):
        self._stop.set()


def synthetic_batch(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                    device="cuda"):
    """One-shot batch via ``models.api.make_batch`` (smoke tests and the
    card's training check)."""
    from repro_torch.models import api
    return api.make_batch(cfg, shape, seed, device)

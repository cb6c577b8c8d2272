"""Parameter-server training with the paper's three coordination modes
(§4.4, Figure 4): asynchronous, synchronous, and synchronous with backup
workers, all built from the core engine's unprivileged primitives
(variables on ps tasks, concurrent steps).

  async   (Fig 4a): every worker loop independently reads params, computes
          grads on its device, applies AssignSub directly (hogwild).
  sync    (Fig 4b): workers put (step, grads) on a gradient queue; a
          coordinator takes all n, averages them on the card
          (``torch.stack(...).mean(0)``: the grads never leave the
          device), applies them atomically, then releases the next step.
  backup  (Fig 4c): the coordinator takes the FIRST m = n - b updates of a
          step and discards stragglers' (proactive straggler mitigation;
          the paper measured up to 15% throughput gain).

The models draw their initial values from numpy with the JAX package's
seeds, so both packages start from the same state.
"""

from __future__ import annotations

import queue as pyq
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.cluster import Cluster
from repro_torch.core.gradients import gradients
from repro_torch.core.graph import Graph, Tensor
from repro_torch.core.session import Session


@dataclass
class PSModel:
    """A model definition over the graph: variables live on ps:*."""
    graph: Graph
    var_handles: list          # Variable handle tensors
    var_reads: list[Tensor]    # Read tensors
    build_replica: callable    # (reads, x, y) -> (loss, grads)


def linear_model(graph: Graph, dim_in: int, dim_out: int, n_shards: int,
                 seed: int = 0):
    """Simple dense model, parameters sharded across PS tasks (§6.2-style)."""
    rng = np.random.default_rng(seed)
    handles, reads = [], []
    shard = dim_out // n_shards
    for i in range(n_shards):
        h = graph.apply("Variable", var_name=f"w{i}",
                        initial=rng.normal(0, 0.1, (dim_in, shard)
                                           ).astype(np.float32),
                        device="ps:*")
        handles.append(h)
        reads.append(graph.apply("Read", h))

    def build_replica(reads, x, y):
        logits = graph.apply("Concat", *[
            graph.apply("MatMul", x, r) for r in reads], axis=-1) \
            if len(reads) > 1 else graph.apply("MatMul", x, reads[0])
        loss = graph.apply("SoftmaxXent", logits, y)
        grads = gradients(loss, reads)
        return loss, grads

    return PSModel(graph, handles, reads, build_replica)


@dataclass
class TrainerStats:
    step_times: list[float] = field(default_factory=list)
    losses: list[float] = field(default_factory=list)
    discarded: int = 0


class PSTrainer:
    """Drives n_workers worker threads in one of the three §4.4 modes."""

    def __init__(self, model: PSModel, cluster: Cluster, *, mode: str,
                 n_workers: int, backup_workers: int = 0, lr: float = 0.1,
                 straggler_s: float = 0.0, straggler_every: int = 0):
        if mode not in ("async", "sync", "backup"):
            raise ValueError(f"mode must be async, sync or backup: {mode!r}")
        self.model = model
        self.cluster = cluster
        self.mode = mode
        self.n_workers = n_workers
        self.m_required = n_workers - (backup_workers if mode == "backup"
                                       else 0)
        self.lr = lr
        self.straggler_s = straggler_s
        self.straggler_every = straggler_every
        self.graph = model.graph
        self.session = Session(self.graph, cluster,
                               default_device="worker:0")
        self.stats = TrainerStats()
        self._build()

    def _build(self):
        gph, m = self.graph, self.model
        # per-worker replica subgraphs, placed on the worker device (§4.4)
        self.replicas = []
        for w in range(self.n_workers):
            dev = f"worker:{w}"
            with gph.device(dev):
                x = gph.placeholder(f"x_{w}")
                y = gph.placeholder(f"y_{w}")
                loss, grads = m.build_replica(m.var_reads, x, y)
            self.replicas.append((x, y, loss, grads))
        # apply path: placeholders for (averaged) grads -> AssignSub on PS
        self.grad_phs, self.apply_ops = [], []
        lr_c = gph.constant(np.float32(self.lr))
        for i, h in enumerate(m.var_handles):
            ph = gph.placeholder(f"gin_{i}")
            self.grad_phs.append(ph)
            self.apply_ops.append(
                gph.apply("AssignSub", h, gph.apply("Mul", lr_c, ph)))

    # -- worker loops --------------------------------------------------------

    def _maybe_straggle(self, w: int, step: int):
        if self.straggler_s and self.straggler_every and \
                (step + w) % self.straggler_every == 0:
            time.sleep(self.straggler_s)

    def train(self, steps: int, batch_fn) -> TrainerStats:
        if self.mode == "async":
            return self._train_async(steps, batch_fn)
        return self._train_sync(steps, batch_fn)

    def _run_threads(self, worker):
        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(self.n_workers)]
        for t in threads:
            t.start()
        return threads

    def _train_async(self, steps: int, batch_fn) -> TrainerStats:
        lock = threading.Lock()
        errors = []

        def worker(w):
            x, y, loss, grads = self.replicas[w]
            try:
                for s in range(steps):
                    self._maybe_straggle(w, s)
                    xv, yv = batch_fn(w, s)
                    t0 = time.perf_counter()
                    vals = self.session.run([loss] + grads, {x: xv, y: yv})
                    self.session.run(self.apply_ops, dict(
                        zip(self.grad_phs, vals[1:])))
                    lv = float(vals[0])
                    dt = time.perf_counter() - t0
                    with lock:
                        self.stats.step_times.append(dt)
                        self.stats.losses.append(lv)
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        for t in self._run_threads(worker):
            t.join()
        if errors:
            raise errors[0]
        return self.stats

    def _train_sync(self, steps: int, batch_fn) -> TrainerStats:
        """Figure 4(b)/(c): gradient queue + barrier tokens, first-m-of-n."""
        grad_q: pyq.Queue = pyq.Queue()
        go_qs = [pyq.Queue() for _ in range(self.n_workers)]

        def worker(w):
            x, y, loss, grads = self.replicas[w]
            try:
                for s in range(steps):
                    go_qs[w].get()           # barrier: wait for step release
                    self._maybe_straggle(w, s)
                    xv, yv = batch_fn(w, s)
                    vals = self.session.run([loss] + grads, {x: xv, y: yv})
                    grad_q.put((s, w, vals[0], vals[1:]))
            except BaseException as e:  # noqa: BLE001
                grad_q.put((None, w, e, None))

        threads = self._run_threads(worker)
        for s in range(steps):
            for q in go_qs:
                q.put(s)                 # release all workers
            t0 = time.perf_counter()
            got, losses = [], []
            while len(got) < self.m_required:
                sid, w, lv, gvals = grad_q.get()
                if sid is None:
                    raise lv
                if sid != s:
                    self.stats.discarded += 1
                    continue
                got.append(gvals)
                losses.append(lv)
            # aggregate first-m on the device and apply atomically
            avg = [torch.stack([gg[i] for gg in got]).mean(0)
                   for i in range(len(self.grad_phs))]
            self.session.run(self.apply_ops,
                             dict(zip(self.grad_phs, avg)))
            # drain stragglers of this step without blocking the next one
            while not grad_q.empty():
                try:
                    sid, w, lv, _ = grad_q.get_nowait()
                except pyq.Empty:
                    break
                if sid is None:
                    raise lv
                self.stats.discarded += 1
            self.stats.step_times.append(time.perf_counter() - t0)
            self.stats.losses.append(float(np.mean([float(v)
                                                    for v in losses])))
        for t in threads:
            t.join(timeout=5.0)
        return self.stats

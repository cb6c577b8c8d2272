"""LSTM language model on the dataflow graph engine (paper §6.4).

The paper trains LSTM-512-512 on 1B-word with the vocabulary-sharded softmax
of §4.2, comparing *full* softmax (logits computed shard-by-shard, colocated
with the weight shard, Project-Adam style) against *sampled* softmax
(Gather of sampled rows, small local matmul). This builds both variants as
pure graph code: unrolled LSTM cell, embedding + softmax weights
round-robined over ps:*, autodiff through the whole thing. The numpy draws
(initial values, sampled ids, batches) are the JAX package's, seed for
seed.

As in the JAX package, the cell unrolls ``unroll`` steps over the same
embedded batch (compute-equivalent for throughput), and the sampled
variant takes no true-class row: its labels are taken mod the number of
sampled rows.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.gradients import gradients
from repro_torch.core.graph import Graph
from repro_torch.ps.training import PSModel


def _lstm_cell(g: Graph, x, h, c, w):
    """One LSTM step from per-gate weight dict w (graph Tensors)."""
    gates = {}
    for name in ("i", "f", "o", "g"):
        z = g.apply("Add", g.apply("MatMul", x, w[f"wx_{name}"]),
                    g.apply("MatMul", h, w[f"wh_{name}"]))
        gates[name] = g.apply("Tanh" if name == "g" else "Sigmoid", z)
    c2 = g.apply("Add", g.apply("Mul", gates["f"], c),
                 g.apply("Mul", gates["i"], gates["g"]))
    h2 = g.apply("Mul", gates["o"], g.apply("Tanh", c2))
    return h2, c2


def lstm_lm_model(graph: Graph, *, vocab: int, d: int, unroll: int,
                  n_ps: int, softmax: str = "full", n_sampled: int = 64,
                  seed: int = 0) -> PSModel:
    if softmax not in ("full", "sampled"):
        raise ValueError(f"softmax must be full or sampled: {softmax!r}")
    rng = np.random.default_rng(seed)
    g = graph

    def var(name, shape, device="ps:*", scale=0.1):
        h = g.apply("Variable", var_name=name,
                    initial=rng.normal(0, scale, shape).astype(np.float32),
                    device=device)
        return h, g.apply("Read", h)

    handles, reads = [], []
    emb_h, emb_r = var("embedding", (vocab, d))
    handles.append(emb_h)
    reads.append(emb_r)
    cell_w = {}
    for name in ("i", "f", "o", "g"):
        for pre in ("wx", "wh"):
            h, r = var(f"{pre}_{name}", (d, d))
            handles.append(h)
            reads.append(r)
            cell_w[f"{pre}_{name}"] = r
    # vocab-sharded softmax weights: one shard per PS task (§4.2)
    shard = vocab // n_ps
    sm_reads = []
    for i in range(n_ps):
        h, r = var(f"softmax_{i}", (d, shard), device=f"ps:{i}")
        handles.append(h)
        reads.append(r)
        sm_reads.append(r)

    def colocate(t, r):
        t.op.colocation = r.op.name       # run on the weight's task
        t.op.device = None                # colocation wins over the
                                          # ambient worker device

    def build_replica(reads_, x_ids, y_ids):
        # x_ids: (B,) ids; the embedding lookup is a Gather on the
        # (possibly remote) table; the cell unrolls over the same embedded
        # batch
        emb = g.apply("Gather", emb_r, x_ids)            # (B, d)
        hstate = g.apply("Mul", emb, g.constant(np.float32(0.0)))
        cstate = hstate
        for _ in range(unroll):
            hstate, cstate = _lstm_cell(g, emb, hstate, cstate, cell_w)
        if softmax == "full":
            # shard-local matmuls (colocated with the weights), then concat
            logits = [g.apply("MatMul", hstate, r) for r in sm_reads]
            for t, r in zip(logits, sm_reads):
                colocate(t, r)
            full = g.apply("Concat", *logits, axis=-1) \
                if len(logits) > 1 else logits[0]
            loss = g.apply("SoftmaxXent", full, y_ids)
        else:
            # sampled: gather n_sampled/n_ps rows from EACH weight shard
            # (disjoint by construction), small local matmul: the §6.4
            # "78x less data transfer and computation" mechanism. The
            # Gather reads a Transpose, a strided view: on the card it
            # copies the shard to contiguous rows first.
            per = max(n_sampled // n_ps, 1)
            rows = []
            for r in sm_reads:
                local_ids = g.constant(
                    rng.choice(shard, per, replace=False).astype(np.int64))
                rt = g.apply("Transpose", r)              # (shard, d)
                got = g.apply("Gather", rt, local_ids)    # (per, d)
                colocate(got, r)
                colocate(rt, r)
                rows.append(got)
            w_s = (g.apply("Concat", *rows, axis=0) if len(rows) > 1
                   else rows[0])                           # (n_sampled, d)
            logits = g.apply("MatMul", hstate, g.apply("Transpose", w_s))
            y_mod = g.apply("Mod", y_ids,
                            g.constant(np.int64(per * n_ps)))
            loss = g.apply("SoftmaxXent", logits, y_mod)
        grads = gradients(loss, reads_)
        grads = [gr if gr is not None else g.constant(np.float32(0.0))
                 for gr in grads]
        return loss, grads

    return PSModel(graph, handles, reads, build_replica)


def lm_batch_fn(vocab: int, batch: int, unroll: int, seed: int = 0):
    rng = np.random.default_rng(seed)

    def fn(w, s):
        x = rng.integers(0, vocab, batch).astype(np.int64)
        y = rng.integers(0, vocab, batch).astype(np.int64)
        return x, y

    return fn

"""Dynamic control flow (paper §3.4): Switch/Merge conditionals.

``cond`` builds a non-strict conditional subgraph (Figure 2): every input is
demultiplexed by Switch on the predicate; each branch computes on its live
half; Merge forwards whichever branch produced a value, dead tensors
propagating through the untaken side. The executor's dead-propagation rule
(core.executor) makes only the taken branch execute.

Iteration: the paper builds while-loops from Switch/Merge with
timely-dataflow frame structure. Conditionals are reproduced in full;
``while_loop`` is a client-driven iteration over a cached step (re-firing
the loop-body subgraph with state in Variables), as in the JAX package.
"""

from __future__ import annotations

from repro_torch.core.graph import Tensor


def cond(pred: Tensor, true_fn, false_fn, inputs: list[Tensor]):
    """Non-strict conditional: executes exactly one branch's subgraph."""
    graph = pred.op.graph
    f_in, t_in = [], []
    for x in inputs:
        f, t = graph.apply("Switch", x, pred)
        f_in.append(f)
        t_in.append(t)
    t_out = true_fn(*t_in)
    f_out = false_fn(*f_in)
    if isinstance(t_out, Tensor):
        t_out, f_out = [t_out], [f_out]
    outs = []
    for tv, fv in zip(t_out, f_out):
        merged, _ = graph.apply("Merge", tv, fv)
        outs.append(merged)
    return outs[0] if len(outs) == 1 else outs


def while_loop(session, cond_fetch: Tensor, body_fetches,
               feeds=None, max_iters: int = 10_000) -> int:
    """Client-driven loop: repeatedly run the cached body step while the
    condition fetch is truthy. State lives in Variables, so each firing
    sees the previous iteration's effects (§3.2 concurrent-steps model)."""
    iters = 0
    while iters < max_iters:
        if not bool(session.run(cond_fetch, feeds)):
            break
        session.run(body_fetches, feeds)
        iters += 1
    return iters

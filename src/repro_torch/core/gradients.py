"""User-level automatic differentiation (paper §4.1).

Breadth-first search from the target (loss) back to the parameters; each
op's registered grad function emits *new graph nodes*; multiple backward
paths into the same tensor are summed with AddN. Differentiation is a
library over the graph, not a runtime feature, so users can specialize
gradients (the paper cites batch norm and gradient clipping as
user-contributed examples; the ps/ training loops use these gradients to
build their updates, §4.1).

The default seed gradient is a float32 one: the reference's float64 seed
promotes float32 variables to float64 under numpy 2's rules; torch's 0-d
promotion would not, but a float32 seed keeps every gradient float32 by
construction.
"""

from __future__ import annotations

from collections import defaultdict, deque

import numpy as np

from repro_torch.core.graph import Tensor, get_opdef


def gradients(target: Tensor, xs: list[Tensor],
              grad_y: Tensor | None = None) -> list[Tensor | None]:
    graph = target.op.graph

    # ops on a backward path: reverse-reachable from target (the paper's
    # BFS path identification)
    reach_back: set[str] = set()
    dq = deque([target.op])
    while dq:
        op = dq.popleft()
        if op.name in reach_back:
            continue
        reach_back.add(op.name)
        for t in op.inputs:
            dq.append(t.op)

    # accumulate per-tensor partial gradients
    partials: dict[str, list[Tensor]] = defaultdict(list)
    if grad_y is None:
        grad_y = graph.constant(np.float32(1.0))
    partials[target.name].append(grad_y)

    order = graph.topo_order({graph.ops[n] for n in reach_back})
    grads_of: dict[str, Tensor] = {}

    def grad_for(t: Tensor) -> Tensor | None:
        if t.name in grads_of:
            return grads_of[t.name]
        ps = partials.get(t.name)
        if not ps:
            return None
        out = ps[0] if len(ps) == 1 else graph.apply("AddN", *ps)
        grads_of[t.name] = out
        return out

    for op in reversed(order):
        out_grads = [grad_for(t) for t in op.outputs]
        if all(gd is None for gd in out_grads):
            continue
        opdef = get_opdef(op.type)
        if opdef.grad is None:
            continue  # non-differentiable leaf (labels, ids, state handles)
        in_grads = opdef.grad(op, *out_grads)
        for t, gd in zip(op.inputs, in_grads):
            if gd is not None:
                partials[t.name].append(gd)

    return [grad_for(x) for x in xs]

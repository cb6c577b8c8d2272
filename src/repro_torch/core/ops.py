"""Standard operation library (paper §5: "over 200 standard operations").

Kernels are torch functions dispatched by the executor on the tensors of
their task's device; gradients build new graph nodes (user-level autodiff,
§4.1). The subset here covers everything the paper's case studies need:
math, array manipulation, state (variables, queues via
core.variables/core.queues), sparse embedding primitives (Gather /
DynamicPartition / DynamicStitch, §4.2), control flow (Switch / Merge,
§3.4) and checkpointing (Save / Restore, §4.3).

Where torch and numpy differ, the ops keep numpy's meaning: ``Mod`` and
``FloorDiv`` follow the divisor's sign, reductions take ``axis=None`` and
``keepdims``, ``Transpose`` swaps the last two axes (a view). ``Gather`` on
a CUDA tensor runs the hand-written gather kernel
(``kernels.embedding.gather``); on a CPU tensor it is torch indexing.
"""

from __future__ import annotations

import torch

from repro_torch.core.graph import Graph, OpDef, Tensor, register
from repro_torch.kernels import embedding as emb


# A sentinel flowing along untaken conditional branches (§3.4).


class Dead:
    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self):
        return "<dead>"


DEAD = Dead()


def g(t: Tensor) -> Graph:
    return t.op.graph


# ---------------------------------------------------------------------------
# basic ops
# ---------------------------------------------------------------------------

register(OpDef("Const", 1, lambda ctx, attrs: (attrs["value"],)))
register(OpDef("Placeholder", 1,
               lambda ctx, attrs: (_ for _ in ()).throw(
                   RuntimeError("placeholder must be fed"))))
register(OpDef("NoOp", 0, lambda ctx, attrs: ()))
register(OpDef("Identity", 1, lambda ctx, attrs, x: (x,),
               grad=lambda op, dy: [dy]))


def _binop(name, fn, grad):
    register(OpDef(name, 1, lambda ctx, attrs, a, b: (fn(a, b),), grad=grad))


_binop("Add", lambda a, b: a + b,
       lambda op, dy: [_unbroadcast(dy, op.inputs[0]),
                       _unbroadcast(dy, op.inputs[1])])
_binop("Sub", lambda a, b: a - b,
       lambda op, dy: [_unbroadcast(dy, op.inputs[0]),
                       _unbroadcast(-dy, op.inputs[1])])
_binop("Mul", lambda a, b: a * b,
       lambda op, dy: [_unbroadcast(dy * op.inputs[1], op.inputs[0]),
                       _unbroadcast(dy * op.inputs[0], op.inputs[1])])
_binop("Div", lambda a, b: a / b,
       lambda op, dy: [
           _unbroadcast(dy * g(dy).apply("Reciprocal", op.inputs[1]),
                        op.inputs[0]),
           _unbroadcast(
               -dy * op.inputs[0]
               * g(dy).apply("Reciprocal",
                             op.inputs[1] * op.inputs[1]), op.inputs[1])])
_binop("Maximum", torch.maximum, None)
_binop("Pow", torch.pow, None)
# numpy's floor division and modulo: the result takes the divisor's sign
_binop("FloorDiv", lambda a, b: a // b, None)
_binop("Mod", torch.remainder, None)
_binop("Less", lambda a, b: a < b, None)
_binop("Greater", lambda a, b: a > b, None)
_binop("Equal", lambda a, b: a == b, None)


def _unbroadcast(dy: Tensor, x: Tensor) -> Tensor:
    """Sum dy down to x's shape (runtime-shaped via UnbroadcastTo kernel)."""
    return g(dy).apply("UnbroadcastLike", dy, x)


def _unbroadcast_kernel(ctx, attrs, dy, x):
    if dy.shape == x.shape:
        return (dy,)
    extra = dy.dim() - x.dim()
    if extra > 0:
        dy = dy.sum(dim=tuple(range(extra)))
    axes = tuple(i for i, (a, b) in enumerate(zip(dy.shape, x.shape))
                 if b == 1 and a != 1)
    if axes:
        dy = dy.sum(dim=axes, keepdim=True)
    return (dy.reshape(x.shape),)


register(OpDef("UnbroadcastLike", 1, _unbroadcast_kernel))

register(OpDef("Neg", 1, lambda ctx, attrs, x: (-x,),
               grad=lambda op, dy: [-dy]))
register(OpDef("Reciprocal", 1, lambda ctx, attrs, x: (1.0 / x,)))
register(OpDef("Exp", 1, lambda ctx, attrs, x: (torch.exp(x),),
               grad=lambda op, dy: [dy * op.outputs[0]]))
register(OpDef("Log", 1, lambda ctx, attrs, x: (torch.log(x),),
               grad=lambda op, dy: [
                   dy * g(dy).apply("Reciprocal", op.inputs[0])]))
register(OpDef("Tanh", 1, lambda ctx, attrs, x: (torch.tanh(x),),
               grad=lambda op, dy: [
                   dy * (g(dy).constant(1.0)
                         - op.outputs[0] * op.outputs[0])]))
register(OpDef("Sigmoid", 1,
               lambda ctx, attrs, x: (1.0 / (1.0 + torch.exp(-x)),),
               grad=lambda op, dy: [
                   dy * op.outputs[0] * (g(dy).constant(1.0)
                                         - op.outputs[0])]))
register(OpDef("Relu", 1, lambda ctx, attrs, x: (torch.clamp(x, min=0.0),),
               grad=lambda op, dy: [
                   g(dy).apply("ReluGrad", dy, op.inputs[0])]))
register(OpDef("ReluGrad", 1,
               lambda ctx, attrs, dy, x: (dy * (x > 0),)))
register(OpDef("Sqrt", 1, lambda ctx, attrs, x: (torch.sqrt(x),)))
register(OpDef("Square", 1, lambda ctx, attrs, x: (torch.square(x),),
               grad=lambda op, dy: [dy * op.inputs[0]
                                    * g(dy).constant(2.0)]))


def _matmul_grad(op, dy):
    a, b = op.inputs
    gr = g(dy)
    da = gr.apply("MatMul", dy, gr.apply("Transpose", b))
    db = gr.apply("MatMul", gr.apply("Transpose", a), dy)
    return [da, db]


register(OpDef("MatMul", 1, lambda ctx, attrs, a, b: (a @ b,),
               grad=_matmul_grad))
register(OpDef("Transpose", 1,
               lambda ctx, attrs, x: (x.transpose(-1, -2),),
               grad=lambda op, dy: [g(dy).apply("Transpose", dy)]))
register(OpDef("Reshape", 1,
               lambda ctx, attrs, x: (torch.reshape(x, attrs["shape"]),),
               grad=lambda op, dy: [
                   g(dy).apply("ReshapeLike", dy, op.inputs[0])]))
register(OpDef("ReshapeLike", 1,
               lambda ctx, attrs, x, like: (torch.reshape(x, like.shape),)))


def _axes(axis):
    return (axis,) if isinstance(axis, int) else tuple(axis)


def _reduce(name, fn, grad):
    """numpy's reduction signature: ``axis`` None (all axes), an int or a
    tuple, and ``keepdims``."""
    def compute(ctx, attrs, x):
        axis, keep = attrs.get("axis"), attrs.get("keepdims", False)
        if axis is None:
            out = fn(x, tuple(range(x.dim())), False)
            return (out.reshape((1,) * x.dim()) if keep else out,)
        return (fn(x, _axes(axis), keep),)
    register(OpDef(name, 1, compute, grad=grad))


def _sum_grad(op, dy):
    return [g(dy).apply("BroadcastLike", dy, op.inputs[0],
                        axis=op.attrs.get("axis"),
                        keepdims=op.attrs.get("keepdims", False))]


def _mean_grad(op, dy):
    gr = g(dy)
    bl = gr.apply("BroadcastLike", dy, op.inputs[0],
                  axis=op.attrs.get("axis"),
                  keepdims=op.attrs.get("keepdims", False))
    return [gr.apply("MeanScale", bl, op.inputs[0],
                     axis=op.attrs.get("axis"))]


def _mean(x, dims, keep):
    # numpy's mean of an integer array is float64
    x = x if x.is_floating_point() else x.double()
    return x.mean(dim=dims, keepdim=keep) if dims else x.clone()


_reduce("ReduceSum",
        lambda x, dims, keep: x.sum(dim=dims, keepdim=keep) if dims
        else x.clone(), _sum_grad)
_reduce("ReduceMean", _mean, _mean_grad)
_reduce("ReduceMax", lambda x, dims, keep: x.amax(dim=dims, keepdim=keep),
        None)


def _broadcast_like(ctx, attrs, dy, x):
    axis = attrs.get("axis")
    if not attrs.get("keepdims", False) and axis is not None:
        for ax in sorted(a % x.dim() for a in _axes(axis)):
            dy = dy.unsqueeze(ax)
    return (dy.expand(x.shape),)


register(OpDef("BroadcastLike", 1, _broadcast_like))
register(OpDef("MeanScale", 1,
               lambda ctx, attrs, bl, x: (
                   bl * _mean_count(x, attrs.get("axis")),)))


def _mean_count(x, axis):
    if axis is None:
        return 1.0 / x.numel()
    n = 1
    for a in _axes(axis):
        n *= x.shape[a % x.dim()]
    return 1.0 / n


def _addn(ctx, attrs, *xs):
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return (out,)


register(OpDef("AddN", 1, _addn,
               grad=lambda op, dy: [dy for _ in op.inputs]))

register(OpDef("Softmax", 1, lambda ctx, attrs, x: (_softmax(x),)))


def _softmax(x):
    m = x.amax(dim=-1, keepdim=True)
    e = torch.exp(x - m)
    return e / e.sum(dim=-1, keepdim=True)


def _xent(ctx, attrs, logits, labels):
    p = _softmax(logits)
    n = logits.shape[0]
    rows = torch.arange(n, device=logits.device)
    ll = -torch.log(torch.clamp(p[rows, labels.long()], min=1e-30))
    return (ll.mean(),)


def _xent_grad(op, dy):
    return [g(dy).apply("SoftmaxXentGrad", dy, op.inputs[0], op.inputs[1]),
            None]


def _xent_grad_kernel(ctx, attrs, dy, logits, labels):
    p = _softmax(logits)
    n = logits.shape[0]
    rows = torch.arange(n, device=logits.device)
    p[rows, labels.long()] -= 1.0
    return (dy * p / n,)


register(OpDef("SoftmaxXent", 1, _xent, grad=_xent_grad))
register(OpDef("SoftmaxXentGrad", 1, _xent_grad_kernel))


# ---------------------------------------------------------------------------
# sparse embedding primitives (§4.2): Gather / DynamicPartition / Stitch
# ---------------------------------------------------------------------------


def gather(params, ids):
    """``params[ids]`` over the first axis: (*ids.shape, *params.shape[1:]).

    On a CUDA tensor, the hand-written gather kernel over the table seen as
    (V, prod(rest)) rows (made contiguous first if ``params`` is a view,
    e.g. a Transpose), with the ids as int32 on the same card; there an id
    out of range is clamped by the kernel's rule (a negative id counts from
    the end, then the row is clamped into [0, V)) and does not raise. On a
    CPU tensor, torch indexing, as numpy indexes: a negative id counts from
    the end, an id out of range raises IndexError."""
    if not params.is_cuda:
        return params[ids.long()]
    rest = params.shape[1:]
    table = params.reshape(params.shape[0], -1)
    if not table.is_contiguous():
        table = table.contiguous()
    out = emb.gather(table, ids.to(torch.int32))
    return out.reshape(*ids.shape, *rest)


def _gather_grad(op, dy):
    gr = g(dy)
    # sparse gradient: scatter dy rows back at the gathered indices
    return [gr.apply("ScatterAddGrad", dy, op.inputs[0], op.inputs[1]),
            None]


register(OpDef("Gather", 1,
               lambda ctx, attrs, params, ids: (gather(params, ids),),
               grad=_gather_grad))


def scatter_rows(ids, rows, V):
    """(flat int64 rows, the row values as (n, *rest)) for ``index_add_``
    into a first axis of V, with numpy's indexing of ``np.add.at``: a
    negative id counts from the end. On the CPU an id still out of range
    raises in ``index_add_``; on the card it is dropped, as the gather
    kernel's clamped read is (the gradient of ``table[ids]`` under jnp's
    rule). ``index_add_`` sums repeated ids with atomics there, in no fixed
    order."""
    flat = ids.reshape(-1).long()
    rows = rows.reshape(flat.shape[0], *rows.shape[ids.dim():])
    flat = torch.where(flat < 0, flat + V, flat)
    if flat.is_cuda:
        keep = (flat >= 0) & (flat < V)
        rows = torch.where(keep.reshape(-1, *[1] * (rows.dim() - 1)),
                           rows, 0)
        flat = flat.clamp(0, V - 1)
    return flat, rows


def _scatter_add_grad(ctx, attrs, dy, params, ids):
    flat, rows = scatter_rows(ids, dy, params.shape[0])
    out = torch.zeros_like(params)
    out.index_add_(0, flat, rows.to(out.dtype))
    return (out,)


register(OpDef("ScatterAddGrad", 1, _scatter_add_grad))


def _dynamic_partition(ctx, attrs, data, partitions):
    n = attrs["num_partitions"]
    return tuple(data[partitions == i] for i in range(n))


def _dynamic_partition_grad(op, *dys):
    gr = op.graph
    n = op.attrs["num_partitions"]
    idx = gr.apply("DynamicPartitionIndices", op.inputs[1],
                   num_partitions=n)
    idx = idx if isinstance(idx, tuple) else (idx,)
    stitched = gr.apply("DynamicStitch", *idx, *dys, n=n)
    return [stitched, None]


register(OpDef("DynamicPartition", None, _dynamic_partition,
               grad=_dynamic_partition_grad,
               num_outputs_fn=lambda attrs: attrs["num_partitions"]))


def _dp_indices(ctx, attrs, partitions):
    n = attrs["num_partitions"]
    idx = torch.arange(len(partitions), device=partitions.device)
    return tuple(idx[partitions == i] for i in range(n))


register(OpDef("DynamicPartitionIndices", None, _dp_indices,
               num_outputs_fn=lambda attrs: attrs["num_partitions"]))


def _dynamic_stitch(ctx, attrs, *args):
    """out[indices[i]] = data[i] for each i. Assumes the indices are
    unique, as every graph here stitches them (DynamicPartitionIndices'
    outputs): with a repeat, numpy keeps the last write, while
    ``index_put_`` on the card promises no order."""
    n = attrs["n"]
    indices, data = args[:n], args[n:]
    total = int(sum(len(i) for i in indices))
    sample = next((d for d in data if len(d)), data[0])
    out = sample.new_zeros((total,) + tuple(sample.shape[1:]))
    for i, d in zip(indices, data):
        out[i.long()] = d
    return (out,)


def _dynamic_stitch_grad(op, dy):
    gr = g(dy)
    n = op.attrs["n"]
    grads = [None] * n
    for i in range(n):
        grads.append(gr.apply("Gather", dy, op.inputs[i]))
    return grads


register(OpDef("DynamicStitch", 1, _dynamic_stitch,
               grad=_dynamic_stitch_grad))


def _concat_kernel(ctx, attrs, *xs):
    return (torch.cat(xs, dim=attrs.get("axis", -1)),)


def _concat_grad(op, dy):
    gr = g(dy)
    outs = gr.apply("ConcatGrad", dy, *op.inputs,
                    axis=op.attrs.get("axis", -1), n=len(op.inputs))
    outs = outs if isinstance(outs, tuple) else (outs,)
    return list(outs)


def _concat_grad_kernel(ctx, attrs, dy, *xs):
    axis = attrs.get("axis", -1)
    out, off = [], 0
    for x in xs:
        w = x.shape[axis]
        out.append(dy.narrow(axis, off, w).contiguous())
        off += w
    return tuple(out)


register(OpDef("ConcatGrad", None, _concat_grad_kernel,
               num_outputs_fn=lambda attrs: attrs["n"]))
register(OpDef("Concat", 1, _concat_kernel, grad=_concat_grad))


# ---------------------------------------------------------------------------
# control flow (§3.4): Switch / Merge with dead propagation
# ---------------------------------------------------------------------------


def _switch(ctx, attrs, data, pred):
    # a host read of the predicate: on the card, a sync, as it must be
    if bool(pred):
        return (DEAD, data)
    return (data, DEAD)


def _merge(ctx, attrs, *xs):
    live = [x for x in xs if x is not DEAD]
    if not live:
        return (DEAD, DEAD)
    return (live[0], torch.tensor(len(live), dtype=torch.int64,
                                  device=ctx.task.device))


register(OpDef("Switch", 2, _switch))
register(OpDef("Merge", 2, _merge))

"""The dataflow graph (paper §3.1): operations, tensors, mutable state.

A ``Graph`` holds ``Operation`` vertices; each edge carries a ``Tensor``
(a torch tensor at runtime, on the device of the task that produced it).
Operations may own *mutable state* (variables, queues): state lives at a
vertex, is read and written by executing ops, and is shared between
concurrent step executions of overlapping subgraphs (§3.2).

Ops are created through the registry filled by ``core.ops``,
``core.variables``, ``core.queues`` and ``core.partition``; gradients
(§4.1) are user-level graph-to-graph construction in ``core.gradients``;
placement and partitioning (§3.3) in ``core.placement`` /
``core.partition``. Placement and partitioning never rewrite an op's
inputs: each plan keeps its own input map, so any number of fetch
signatures run over the same ops.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch


class Tensor:
    """A symbolic output slot of an operation."""

    __slots__ = ("op", "index")

    def __init__(self, op: "Operation", index: int):
        self.op = op
        self.index = index

    @property
    def name(self) -> str:
        return f"{self.op.name}:{self.index}"

    def __repr__(self):
        return f"<Tensor {self.name} ({self.op.type})>"

    # small sugar so user-level code (optimizers §4.1) reads naturally
    def __add__(self, other):
        return self.op.graph.apply("Add", self, _lift(self.op.graph, other))

    def __sub__(self, other):
        return self.op.graph.apply("Sub", self, _lift(self.op.graph, other))

    def __mul__(self, other):
        return self.op.graph.apply("Mul", self, _lift(self.op.graph, other))

    def __neg__(self):
        return self.op.graph.apply("Neg", self)

    def __matmul__(self, other):
        return self.op.graph.apply("MatMul", self,
                                   _lift(self.op.graph, other))


def _lift(graph: "Graph", value) -> Tensor:
    if isinstance(value, Tensor):
        return value
    return graph.constant(value)


class Operation:
    """A vertex: a named, typed unit of computation with attrs (§3.1)."""

    def __init__(self, graph: "Graph", op_type: str, name: str,
                 inputs: Sequence[Tensor], attrs: dict,
                 num_outputs: int, control_inputs: Sequence["Operation"] = (),
                 device: str | None = None):
        self.graph = graph
        self.type = op_type
        self.name = name
        self.inputs = list(inputs)
        self.attrs = dict(attrs)
        self.control_inputs = list(control_inputs)
        self.device = device                  # constraint, e.g. "ps:0"
        self.colocation: str | None = self.attrs.pop("_colocate", None)
        self.outputs = [Tensor(self, i) for i in range(num_outputs)]
        # the task of the latest plan that placed this op (for inspection;
        # plans keep their own placement, and a Variable or FIFOQueue keeps
        # its first task for good)
        self.assigned_device: str | None = None

    def output(self, i: int = 0) -> Tensor:
        return self.outputs[i]

    def __repr__(self):
        return f"<Op {self.name} ({self.type}) on {self.assigned_device}>"


@dataclass
class OpDef:
    """Registered operation type: runtime kernel + optional gradient."""
    name: str
    num_outputs: int | None
    # compute(ctx, attrs, *input values) -> tuple of outputs
    compute: Callable
    # grad(op, *output grads) -> list of input grads (Tensors or None)
    grad: Callable | None = None
    stateful: bool = False
    # number of outputs may depend on attrs:
    num_outputs_fn: Callable | None = None


_REGISTRY: dict[str, OpDef] = {}


def register(opdef: OpDef):
    _REGISTRY[opdef.name] = opdef
    return opdef


def get_opdef(op_type: str) -> OpDef:
    if op_type not in _REGISTRY:
        raise KeyError(f"unregistered op type {op_type!r}")
    return _REGISTRY[op_type]


class Graph:
    """A single dataflow graph for all computation and state (§3)."""

    def __init__(self):
        self.ops: dict[str, Operation] = {}
        self._counter = itertools.count()
        self._lock = threading.Lock()
        self._device_stack: list[str] = []

    # -- construction -------------------------------------------------------

    def apply(self, op_type: str, *inputs, name: str | None = None,
              control_inputs: Sequence[Operation] = (),
              **attrs):
        opdef = get_opdef(op_type)
        inputs = [_lift(self, x) for x in inputs]
        with self._lock:
            if name is None:
                name = f"{op_type}_{next(self._counter)}"
            if name in self.ops:
                raise ValueError(f"duplicate op name {name}")
            n_out = (opdef.num_outputs_fn(attrs) if opdef.num_outputs_fn
                     else opdef.num_outputs)
            device = attrs.pop("device", None) or (
                self._device_stack[-1] if self._device_stack else None)
            op = Operation(self, op_type, name, inputs, attrs, n_out,
                           control_inputs, device)
            self.ops[name] = op
        if len(op.outputs) == 1:
            return op.outputs[0]
        return tuple(op.outputs) if op.outputs else op

    def constant(self, value, name: str | None = None):
        """A Const op. ``value``: a torch tensor, or anything numpy takes
        (kept with numpy's dtype: ``constant(1.0)`` is float64, which
        torch's 0-d promotion leaves out of float32 arithmetic). Each plan
        puts it on its task's device once."""
        if not isinstance(value, torch.Tensor):
            value = np.asarray(value)
        return self.apply("Const", value=value, name=name)

    def placeholder(self, name: str | None = None, shape=None, dtype=None):
        return self.apply("Placeholder", shape=shape, dtype=dtype, name=name)

    def device(self, device: str):
        """Context manager applying a device constraint (§3.3)."""
        graph = self

        class _Ctx:
            def __enter__(self):
                graph._device_stack.append(device)

            def __exit__(self, *a):
                graph._device_stack.pop()

        return _Ctx()

    # -- traversal ----------------------------------------------------------

    def op_of(self, t: Tensor | Operation) -> Operation:
        return t.op if isinstance(t, Tensor) else t

    def topo_order(self, ops: set[Operation]) -> list[Operation]:
        """Depth-first post-order over ``ops`` (inputs, then control
        inputs, roots by name): the reference's order, walked with an
        explicit stack so that long chains (an unrolled LSTM's backward,
        2,000 Identity ops) need no recursion."""
        seen: set[str] = set()
        order: list[Operation] = []

        def deps(op: Operation):
            return iter([t.op for t in op.inputs if t.op in ops]
                        + [c for c in op.control_inputs if c in ops])

        for root in sorted(ops, key=lambda o: o.name):
            if root.name in seen:
                continue
            seen.add(root.name)
            stack = [(root, deps(root))]
            while stack:
                op, it = stack[-1]
                for dep in it:
                    if dep.name not in seen:
                        seen.add(dep.name)
                        stack.append((dep, deps(dep)))
                        break
                else:
                    stack.pop()
                    order.append(op)
        return order

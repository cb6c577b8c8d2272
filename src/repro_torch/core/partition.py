"""Graph partitioning with Send/Recv (paper §3.3).

After placement, the pruned subgraph splits into per-device op lists; every
edge crossing devices is cut and replaced by a Send on the producer and a
Recv on the consumer, matched through a *rendezvous key*
``(tensor_name, step_id)``. Send fires as soon as its input is ready; Recv
blocks until the value arrives, and moves it to its own task's device (a
no-op when both tasks share one; a host-card copy otherwise, the paper's
§5 transport specialization). The executor threads give the asynchrony.

A plan never rewrites the graph: each ``DevicePlan`` keeps its own input
map, and its Send/Recv ops belong to the plan, not to ``graph.ops``. So a
second fetch signature that reaches the same ops runs with Send/Recv of its
own. Each plan also puts its Const values on their task's device once.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.graph import (OpDef, Operation, Tensor, get_opdef,
                                    register)


def to_device(value, device):
    """A fed or constant value as a torch tensor on ``device``: numpy
    values keep numpy's dtype; a tensor is moved (a no-op where it is)."""
    if isinstance(value, torch.Tensor):
        return value.to(device)
    return torch.as_tensor(np.asarray(value), device=device)


class Rendezvous:
    """In-process rendezvous: blocking key-value exchange between tasks.
    ``moved_bytes``, ``moved_s`` and ``moves`` count the copies between
    devices that Recv and the executor's feeds make (host clock around
    each copy)."""

    def __init__(self):
        self._store: dict = {}
        self._failed: dict = {}            # step_id -> the error that ended it
        self._cv = threading.Condition()
        self.moved_bytes = 0
        self.moved_s = 0.0
        self.moves = 0

    def send(self, key, value):
        with self._cv:
            self._store[key] = value
            self._cv.notify_all()

    def recv(self, key, timeout=30.0):
        with self._cv:
            ok = self._cv.wait_for(
                lambda: key in self._store or key[1] in self._failed,
                timeout=timeout)
            if key in self._store:
                return self._store.pop(key)
            if ok:
                raise RuntimeError(
                    f"rendezvous recv {key}: step {key[1]} failed on another "
                    "device") from self._failed[key[1]]
            raise TimeoutError(f"rendezvous recv timed out: {key}")

    def fail(self, step_id, error):
        """End ``step_id``: its waiting Recvs raise; its unread values go."""
        with self._cv:
            self._failed.setdefault(step_id, error)
            for key in [k for k in self._store if k[1] == step_id]:
                del self._store[key]
            self._cv.notify_all()

    def move(self, value, device):
        t0 = time.perf_counter()
        out = value.to(device)
        dt = time.perf_counter() - t0
        with self._cv:
            self.moved_bytes += value.numel() * value.element_size()
            self.moved_s += dt
            self.moves += 1
        return out

    def reset_moves(self):
        with self._cv:
            self.moved_bytes, self.moved_s, self.moves = 0, 0.0, 0


def _send(ctx, attrs, value):
    ctx.rendezvous.send((attrs["key"], ctx.step_id), value)
    return ()


def _recv(ctx, attrs):
    v = ctx.rendezvous.recv((attrs["key"], ctx.step_id))
    if isinstance(v, torch.Tensor) and v.device != ctx.task.device:
        v = ctx.rendezvous.move(v, ctx.task.device)
    return (v,)


register(OpDef("Send", 0, _send, stateful=True))
register(OpDef("Recv", 1, _recv, stateful=True))


@dataclass
class Step:
    """One op of a device plan, ready to run: its kernel, its attrs (a
    Const's value already on the device), and the names of the values it
    reads and writes."""
    op: Operation
    compute: object
    attrs: dict
    inputs: list[str]
    outputs: list[str]
    merge: bool


@dataclass
class DevicePlan:
    device: str
    ops: list[Operation] = field(default_factory=list)
    # this plan's inputs of each op (Recv outputs where an edge was cut)
    inputs: dict = field(default_factory=dict)
    feeds: list[str] = field(default_factory=list)   # fed tensors it reads
    steps: list[Step] = field(default_factory=list)

    def add(self, op: Operation, inputs: list[Tensor], attrs: dict):
        self.ops.append(op)
        self.inputs[op] = inputs
        self.steps.append(Step(op, get_opdef(op.type).compute, attrs,
                               [t.name for t in inputs],
                               [t.name for t in op.outputs],
                               op.type == "Merge"))


@dataclass
class Plan:
    """A placed, partitioned, cached execution plan (§3.3 'step cache')."""
    per_device: dict[str, DevicePlan]
    fetch_map: dict[str, tuple[str, str]]   # fetch name -> (device, local)


def partition(graph, ops: list[Operation], fetches: list[Tensor],
              placement: dict, tasks: dict, fed=()) -> Plan:
    """Split ``ops`` by ``placement`` ({op: task name}) into device plans
    with Send/Recv on every edge between tasks. ``tasks`` ({name: Task})
    gives each plan's device for its Const values; ``fed`` names the fed
    tensors (read where they are consumed, never sent)."""
    per_device: dict[str, DevicePlan] = {}
    opset = set(ops)
    fed = set(fed)

    def plan_for(device: str) -> DevicePlan:
        if device not in per_device:
            per_device[device] = DevicePlan(device)
        return per_device[device]

    recv_cache: dict[tuple[str, str], Tensor] = {}

    for op in graph.topo_order(opset):
        dev = placement[op]
        dplan = plan_for(dev)
        new_inputs = []
        for t in op.inputs:
            if t.name in fed or t.op not in opset:
                if t.name not in dplan.feeds:
                    dplan.feeds.append(t.name)
                new_inputs.append(t)
                continue
            src = placement[t.op]
            if src == dev:
                new_inputs.append(t)
                continue
            ck = (t.name, dev)
            if ck not in recv_cache:
                key = f"{t.name}->{dev}"
                send = Operation(graph, "Send",
                                 f"send/{key}".replace(":", "_"), [t],
                                 {"key": key}, 0)
                send.assigned_device = src
                plan_for(src).add(send, [t], send.attrs)
                recv = Operation(graph, "Recv",
                                 f"recv/{key}".replace(":", "_"), [],
                                 {"key": key}, 1)
                recv.assigned_device = dev
                dplan.add(recv, [], recv.attrs)
                recv_cache[ck] = recv.outputs[0]
            new_inputs.append(recv_cache[ck])
        attrs = op.attrs
        if op.type == "Const":
            attrs = dict(attrs, value=to_device(attrs["value"],
                                                tasks[dev].device))
        dplan.add(op, new_inputs, attrs)

    fetch_map = {t.name: (placement[t.op], t.name) for t in fetches}
    return Plan(per_device, fetch_map)

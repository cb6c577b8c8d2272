"""Dataflow executor (paper §3.2, §5).

Prunes the graph to the subgraph needed by the fetches (dead-code
elimination via reverse BFS from fetches, stopping at feeds), then runs each
device's op list in topological order inside that device's task thread.
Blocking ops (Dequeue, Recv, barrier queues) simply block their step thread,
which is how concurrent steps coordinate through shared state.

Every op computes on its task's device; each device plan first puts the
feeds it reads there (a fed tensor on another device is a copy, counted
with the Recv copies). Work on the card goes on the calling thread's
current stream (the default stream): a value one thread hands another
through the rendezvous was launched before it was sent, so launch order
is the order on the device.

Dead-tensor propagation (§3.4): a non-Merge op with any DEAD input skips
execution and emits DEAD on all outputs; Merge forwards its first live
input. This is what makes Switch/Merge conditionals work.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import torch

from repro_torch.core.graph import Graph, Operation, Tensor
from repro_torch.core.ops import DEAD
from repro_torch.core.partition import DevicePlan, to_device


@dataclass
class ExecContext:
    task: object            # owning Task (device, var_store, queue_store)
    rendezvous: object
    step_id: int


def prune(graph: Graph, fetches: list[Tensor],
          feeds: dict[Tensor, object],
          extra_roots: list[Operation] = ()) -> list[Operation]:
    """Reverse BFS from fetches (+explicit roots), stopping at fed tensors."""
    fed = {t.name for t in feeds}
    seen: set[str] = set()
    stack = [t.op for t in fetches] + list(extra_roots)
    ops: list[Operation] = []
    while stack:
        op = stack.pop()
        if op.name in seen:
            continue
        seen.add(op.name)
        ops.append(op)
        for t in op.inputs:
            if t.name not in fed:
                stack.append(t.op)
        stack.extend(op.control_inputs)
    return ops


class DeviceExecutor:
    """Executes one device plan's steps for one step of the graph."""

    def __init__(self, task):
        self.task = task

    def run(self, dplan: DevicePlan, feeds: dict[str, object],
            ctx: ExecContext) -> dict:
        device = self.task.device
        values = {}
        for n in dplan.feeds:
            v = feeds[n]
            values[n] = ctx.rendezvous.move(v, device) \
                if isinstance(v, torch.Tensor) and v.device != device \
                else to_device(v, device)
        for st in dplan.steps:
            args = [values[n] for n in st.inputs]
            if not st.merge and any(a is DEAD for a in args):
                for n in st.outputs:
                    values[n] = DEAD
                continue
            outs = st.compute(ctx, st.attrs, *args)
            for n, v in zip(st.outputs, outs):
                values[n] = v
        return values


def run_plan(plan, tasks: dict[str, object], rendezvous, step_id: int,
             feeds: dict[str, object], fetch_names: list[str],
             timeout: float = 60.0):
    """Run a partitioned Plan: one thread per participating device (§3.3:
    'a distributed step ... one small message to each participating
    task'). A device that fails ends the step on every device (their
    waiting Recvs raise) and its error is raised here; a device still
    running after ``timeout`` seconds raises TimeoutError naming it."""
    results: dict[str, dict] = {}
    errors: list[BaseException] = []

    def run_device(device, dplan):
        task = tasks[device]
        ctx = ExecContext(task=task, rendezvous=rendezvous, step_id=step_id)
        try:
            results[device] = DeviceExecutor(task).run(dplan, feeds, ctx)
        except BaseException as e:  # noqa: BLE001
            errors.append(e)
            rendezvous.fail(step_id, e)

    threads = []
    for device, dplan in plan.per_device.items():
        th = threading.Thread(target=run_device, args=(device, dplan),
                              daemon=True, name=f"step{step_id}/{device}")
        th.start()
        threads.append((device, th))
    deadline = time.monotonic() + timeout
    for _, th in threads:
        th.join(max(0.0, deadline - time.monotonic()))
    stuck = [device for device, th in threads if th.is_alive()]
    if stuck:
        err = TimeoutError(f"step {step_id}: device(s) {stuck} did not "
                           f"finish within {timeout} s")
        rendezvous.fail(step_id, err)
        raise err
    if errors:
        raise errors[0]
    out = []
    for name in fetch_names:
        device, local = plan.fetch_map[name]
        out.append(results[device][local])
    return out

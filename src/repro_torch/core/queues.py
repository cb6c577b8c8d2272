"""Queue operations (paper §3.1): FIFOQueue with blocking Enqueue/Dequeue.

Blocking provides backpressure in input pipelines and acts as the
synchronization primitive for §4.4's replica coordination (barrier queues
and gradient-accumulation queues). Queues are owned state, addressed by a
reference handle like variables; their items are torch tensors on the
queue's task.
"""

from __future__ import annotations

import queue as pyqueue
import threading

import torch

from repro_torch.core.graph import OpDef, register


class QueueClosed(Exception):
    pass


class FIFOQueue:
    def __init__(self, capacity: int):
        self.capacity = capacity
        self._q: pyqueue.Queue = pyqueue.Queue(maxsize=capacity)
        self._closed = threading.Event()

    def enqueue(self, item, timeout=None):
        if self._closed.is_set():
            raise QueueClosed()
        self._q.put(item, timeout=timeout)

    def dequeue(self, timeout=None):
        while True:
            try:
                return self._q.get(timeout=0.05 if timeout is None else
                                   min(timeout, 0.05))
            except pyqueue.Empty:
                if self._closed.is_set() and self._q.empty():
                    raise QueueClosed() from None
                if timeout is not None:
                    timeout -= 0.05
                    if timeout <= 0:
                        raise TimeoutError() from None

    def dequeue_many(self, n: int, timeout=None):
        return [self.dequeue(timeout) for _ in range(n)]

    def close(self):
        self._closed.set()

    def size(self) -> int:
        return self._q.qsize()


class QueueStore:
    def __init__(self):
        self._queues: dict[str, FIFOQueue] = {}
        self._lock = threading.Lock()

    def ensure(self, name: str, capacity: int) -> FIFOQueue:
        with self._lock:
            if name not in self._queues:
                self._queues[name] = FIFOQueue(capacity)
            return self._queues[name]

    def get(self, name: str) -> FIFOQueue:
        return self._queues[name]


class QueueHandle:
    __slots__ = ("name", "store")

    def __init__(self, name, store):
        self.name = name
        self.store = store

    @property
    def queue(self) -> FIFOQueue:
        return self.store.get(self.name)


def _fifo_queue(ctx, attrs):
    name = attrs["queue_name"]
    ctx.task.queue_store.ensure(name, attrs.get("capacity", 64))
    return (QueueHandle(name, ctx.task.queue_store),)


def _enqueue(ctx, attrs, handle, value):
    handle.queue.enqueue(torch.as_tensor(value, device=ctx.task.device))
    return ()


def _dequeue(ctx, attrs, handle):
    return (handle.queue.dequeue(),)


def _dequeue_many(ctx, attrs, handle):
    items = handle.queue.dequeue_many(attrs["n"])
    return (torch.stack(items),)


def _queue_close(ctx, attrs, handle):
    handle.queue.close()
    return ()


def _queue_size(ctx, attrs, handle):
    return (torch.tensor(handle.queue.size(), dtype=torch.int64,
                         device=ctx.task.device),)


register(OpDef("FIFOQueue", 1, _fifo_queue, stateful=True))
register(OpDef("Enqueue", 0, _enqueue, stateful=True))
register(OpDef("Dequeue", 1, _dequeue, stateful=True))
register(OpDef("DequeueMany", 1, _dequeue_many, stateful=True))
register(OpDef("QueueClose", 0, _queue_close, stateful=True))
register(OpDef("QueueSize", 1, _queue_size, stateful=True))

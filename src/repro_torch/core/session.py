"""Client Session (paper §3.2-3.3): partial execution with a step cache.

``Session.run(fetches, feeds)`` selects a subgraph (prune), places it,
partitions it with Send/Recv, caches the plan keyed by the (fetches, feeds)
signature, and executes it as one concurrent step. Multiple ``run`` calls
may execute concurrently against the same mutable state: that is the
paper's data-parallel training pattern (§4.4) and the ps/ package uses it.
Fetches come back as torch tensors on their task's device.
"""

from __future__ import annotations

import threading

from repro_torch.core.cluster import Cluster
from repro_torch.core.executor import prune, run_plan
from repro_torch.core.graph import Graph, Operation, Tensor
from repro_torch.core.partition import partition
from repro_torch.core.placement import place
import repro_torch.core.ops          # noqa: F401  (registers kernels)
import repro_torch.core.queues       # noqa: F401
import repro_torch.core.variables    # noqa: F401


class Session:
    def __init__(self, graph: Graph, cluster: Cluster | None = None,
                 default_device: str | None = None):
        self.graph = graph
        self.cluster = cluster or Cluster(worker=1)
        self.default_device = default_device or self.cluster.devices[0]
        self._plan_cache: dict = {}
        self._lock = threading.Lock()

    def plan(self, fetch_tensors, roots, feeds):
        """The cached plan of this (fetches, roots, fed tensors)
        signature, built at its first use."""
        key = (tuple(t.name for t in fetch_tensors),
               tuple(r.name for r in roots),
               tuple(sorted(t.name for t in feeds)))
        with self._lock:
            plan = self._plan_cache.get(key)
            if plan is None:
                cl = self.cluster
                ops = prune(self.graph, fetch_tensors, feeds, roots)
                with cl.placement_lock:
                    placement = place(ops, cl.devices, self.default_device,
                                      cl.pinned, cl.round_robin)
                plan = partition(self.graph, ops, fetch_tensors, placement,
                                 cl.tasks, [t.name for t in feeds])
                self._plan_cache[key] = plan
        return plan

    def run(self, fetches, feeds: dict | None = None, timeout: float = 60.0):
        single = False
        if isinstance(fetches, (Tensor, Operation)):
            fetches = [fetches]
            single = True
        feeds = feeds or {}
        fetch_tensors = [f if isinstance(f, Tensor) else f.outputs[0]
                         if f.outputs else None for f in fetches]
        roots = [f for f in fetches if isinstance(f, Operation)]
        fetch_tensors = [t for t in fetch_tensors if t is not None]
        plan = self.plan(fetch_tensors, roots, feeds)
        step_id = self.cluster.next_step_id()
        feed_values = {t.name: v for t, v in feeds.items()}
        out = run_plan(plan, self.cluster.tasks, self.cluster.rendezvous,
                       step_id, feed_values,
                       [t.name for t in fetch_tensors], timeout=timeout)
        return out[0] if single and out else out

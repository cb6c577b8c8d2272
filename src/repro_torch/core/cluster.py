"""In-process cluster: named tasks with their own state stores (paper §3.3).

A real deployment maps tasks to processes connected by gRPC/RDMA; here they
are thread domains sharing a Rendezvous, each with a torch device: the
card (``"cuda"``, the default for every task) or the host (``"cpu"``).
Send/Recv between tasks on different devices is a copy (the paper's §5
transport specialization). Task naming follows the paper's
"/job:ps/task:0" scheme, shortened "ps:0".

The cluster also holds what must outlive one plan: the step counter (a
rendezvous key is unique per step across every session on the cluster),
the task each stateful op (Variable, FIFOQueue) was first placed on, and
the ``"job:*"`` round-robin.
"""

from __future__ import annotations

import itertools
import threading

import torch

from repro_torch.core.partition import Rendezvous
from repro_torch.core.queues import QueueStore
from repro_torch.core.variables import VariableStore


def task_device(device) -> torch.device:
    """``device`` as a torch device; a CUDA device needs a card, and there
    is no quiet fallback to the host."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"task device {device}: no CUDA card here; build the cluster "
            "with device='cpu' (or job_devices) to run tasks on the host")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class Task:
    def __init__(self, name: str, device="cuda"):
        self.name = name
        self.device = task_device(device)
        self.var_store = VariableStore(self.device)
        self.queue_store = QueueStore()

    def __repr__(self):
        return f"<Task {self.name} on {self.device}>"


class Cluster:
    """A set of tasks, e.g. ``Cluster(ps=2, worker=4)``: every task on the
    card. ``device="cpu"`` puts every task on the host;
    ``job_devices={"ps": "cpu"}`` sets jobs apart (parameter servers on the
    host, workers on the card, as in the paper's layout)."""

    def __init__(self, device="cuda", job_devices: dict | None = None,
                 **jobs: int):
        job_devices = job_devices or {}
        unknown = set(job_devices) - set(jobs)
        if unknown:
            raise ValueError(f"job_devices names no job: {sorted(unknown)}")
        self.tasks: dict[str, Task] = {}
        for job, n in jobs.items():
            for i in range(n):
                name = f"{job}:{i}"
                self.tasks[name] = Task(name, job_devices.get(job, device))
        self.rendezvous = Rendezvous()
        self._steps = itertools.count()
        self._lock = threading.Lock()
        self.placement_lock = threading.Lock()
        # stateful op -> its task, fixed at its first placement
        self.pinned: dict = {}
        # "job" -> round-robin position over the job's tasks
        self.round_robin: dict[str, int] = {}

    @property
    def devices(self) -> list[str]:
        return list(self.tasks)

    def job(self, job: str) -> list[str]:
        return [d for d in self.tasks if d.startswith(job + ":")]

    def next_step_id(self) -> int:
        with self._lock:
            return next(self._steps)

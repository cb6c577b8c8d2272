"""Device meshes for the port's multi-process runs (port of the mesh half
of ``repro.launch.mesh``, on ``torch.distributed``).

``make_host_mesh(data, model, device_type)`` is a ("data", "model")
``DeviceMesh`` over the default process group, which the caller has
initialized with ``data * model`` ranks. As in the JAX package, serving
reads only the "model" axis (``spmd.sharding.serving_tp``): the data axis
replicates. Training reads both (``spmd.collectives.train_mesh``: the
"data" and "model" groups, rank ``d * model + m`` at (d, m)). ``init_rank`` initializes one rank's process group: NCCL when
every rank has a card of its own, gloo otherwise (the CPU, or several
ranks on one card: NCCL refuses two ranks on one GPU).
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

AXES = ("data", "model")


def parse_mesh(spec: str | None) -> tuple[int, int]:
    """'model=2' / 'data=2,model=4' -> (data, model); None -> (1, 1)."""
    sizes = {"data": 1, "model": 1}
    if spec:
        for part in spec.split(","):
            name, _, val = part.partition("=")
            if name not in sizes or not val.isdigit() or int(val) < 1:
                raise ValueError(
                    f"bad --mesh entry {part!r}: expected data=N / model=N "
                    "with N >= 1")
            sizes[name] = int(val)
    return sizes["data"], sizes["model"]


def backend_for(world: int, device_type: str) -> str:
    """NCCL when each of ``world`` ranks has a card of its own, else
    gloo."""
    if device_type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def init_rank(rank: int, world: int, init_method: str,
              device_type: str = "cuda", timeout_s: float = 300.0) -> str:
    """Join the ``world``-rank process group at ``init_method`` (a
    ``file://`` or ``tcp://localhost:PORT`` URL) as ``rank``, with card
    rank % cards current. Returns the backend."""
    backend = backend_for(world, device_type)
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return backend


def make_host_mesh(data: int = 1, model: int = 1, device_type: str = "cuda"):
    """A ("data", "model") DeviceMesh of ``data * model`` ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    if dist.get_world_size() != data * model:
        raise ValueError(f"a {data} x {model} mesh needs {data * model} "
                         f"ranks, the process group has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(device_type, (data, model), mesh_dim_names=AXES)

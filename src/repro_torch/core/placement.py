"""Device placement (paper §3.3).

The algorithm mirrors the paper: compute a feasible device set per op from
explicit constraints ("ps:0"), partial constraints ("ps:*" = any PS task),
then compute colocation groups (stateful ops and the ops that consume
their reference handles must share a device) and pick a device per group.
Variables with partial "ps:*" constraints round-robin across PS tasks,
which is exactly how the client-side constructs of §3.3 spread parameters.

State must not move: the first plan that places a stateful op (Variable,
FIFOQueue) fixes its task in ``pinned``, and every later plan places its
group there. The round-robin position carries over between plans too, so
a Variable first met by a later plan continues the cycle.
"""

from __future__ import annotations

from repro_torch.core.graph import Operation

HANDLE_PRODUCERS = {"Variable", "FIFOQueue"}
HANDLE_CONSUMERS = {"Read", "Assign", "AssignAdd", "AssignSub",
                    "ScatterAdd", "ScatterSub", "Enqueue", "Dequeue",
                    "DequeueMany", "QueueClose", "QueueSize", "Save"}


def _roots(parent, x):
    while parent[x] != x:
        parent[x] = parent[parent[x]]
        x = parent[x]
    return x


def place(ops: list[Operation], devices: list[str],
          default_device: str | None = None, pinned: dict | None = None,
          round_robin: dict | None = None) -> dict:
    """Returns {op: device} for every op (and sets ``op.assigned_device``).
    ``pinned`` ({stateful op: device}) and ``round_robin`` ({job: next
    position}) are read and updated; pass the cluster's so that they hold
    across plans."""
    default_device = default_device or devices[0]
    pinned = {} if pinned is None else pinned
    round_robin = {} if round_robin is None else round_robin
    parent = {op.name: op.name for op in ops}

    def union(a: str, b: str):
        ra, rb = _roots(parent, a), _roots(parent, b)
        if ra != rb:
            parent[rb] = ra

    # colocation: handle consumers join their handle producer's group
    for op in ops:
        if op.type in HANDLE_CONSUMERS:
            for t in op.inputs:
                if t.op.type in HANDLE_PRODUCERS and t.op.name in parent:
                    union(t.op.name, op.name)
        if op.colocation and op.colocation in parent:
            union(op.colocation, op.name)

    # feasible sets per group = intersection of member constraints
    groups: dict[str, list[Operation]] = {}
    for op in ops:
        groups.setdefault(_roots(parent, op.name), []).append(op)

    placement = {}
    for root, members in sorted(groups.items()):
        feasible = list(devices)
        partial = None
        for op in members:
            c = op.device
            if not c:
                continue
            if c.endswith(":*"):
                job = c[:-2]
                feasible = [d for d in feasible if d.startswith(job + ":")]
                partial = job
            else:
                feasible = [d for d in feasible if d == c]
        if not feasible:
            raise ValueError(
                f"unsatisfiable placement for group {root}: "
                f"{[op.name for op in members]}")
        fixed = {pinned[op] for op in members if op in pinned}
        if len(fixed) > 1 or (fixed and not fixed <= set(feasible)):
            raise ValueError(
                f"group {root} holds state already placed on "
                f"{sorted(fixed)}, outside {feasible}")
        if fixed:
            device = fixed.pop()
        elif partial and len(feasible) > 1:
            # round-robin variables across the job's tasks (§3.3 / §4.2)
            pos = round_robin.get(partial, 0)
            device = feasible[pos % len(feasible)]
            round_robin[partial] = pos + 1
        elif default_device in feasible and not partial:
            device = default_device if len(feasible) == len(devices) \
                else feasible[0]
        else:
            device = feasible[0]
        for op in members:
            placement[op] = device
            op.assigned_device = device
            if op.type in HANDLE_PRODUCERS:
                pinned.setdefault(op, device)
    return placement

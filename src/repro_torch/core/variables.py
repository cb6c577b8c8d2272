"""Stateful operations: variables (paper §3.1) and checkpoint ops (§4.3).

A ``Variable`` op owns a mutable buffer and emits a *reference handle*; Read
/ Assign / AssignAdd / AssignSub / ScatterAdd / ScatterSub consume the
handle and act on the buffer. Buffers are float32 torch tensors in the
``VariableStore`` of whatever task the Variable was *placed* on, on that
task's device: placing a Variable on "ps:0" is what makes ps0 a parameter
server (§3: the PS architecture is a placement decision, not privileged
code). An update that would promote a buffer (a float64 operand) is cast
back to the buffer's dtype, so state stays float32.

Save / Restore (§4.3) are ordinary ops too: one Save per task writes every
connected variable in one ``np.savez`` file from host copies (the JAX
package's layout, so either package restores the other's checkpoints);
Restore loads one array onto its task's device, and Assign
re-materializes state. Consistency is the client's choice.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch.core.graph import OpDef, register
from repro_torch.core.ops import scatter_rows


class VarHandle:
    """Typed capability for a variable's buffer (paper's 'reference')."""

    __slots__ = ("name", "store")

    def __init__(self, name: str, store: "VariableStore"):
        self.name = name
        self.store = store

    def __repr__(self):
        return f"<VarHandle {self.name}>"


def _float32(value, device) -> torch.Tensor:
    """A float32 copy of ``value`` (numpy or torch) on ``device``."""
    if not isinstance(value, torch.Tensor):
        value = torch.from_numpy(np.asarray(value, dtype=np.float32))
    return value.to(device=device, dtype=torch.float32, copy=True)


class VariableStore:
    """Per-task mutable state; thread-safe for concurrent steps (§3.2)."""

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self._buffers: dict[str, torch.Tensor] = {}
        self._locks: dict[str, threading.Lock] = {}
        self._global_lock = threading.Lock()

    def ensure(self, name: str, initial) -> None:
        with self._global_lock:
            if name not in self._buffers:
                self._buffers[name] = _float32(initial, self.device) \
                    if initial is not None else None
                self._locks[name] = threading.Lock()

    def read(self, name: str) -> torch.Tensor:
        """A snapshot: later updates do not change it."""
        return self._buffers[name].clone()

    def assign(self, name: str, value) -> torch.Tensor:
        value = torch.as_tensor(value)
        with self._locks[name]:
            self._buffers[name] = value.to(
                device=self.device, copy=True,
                dtype=torch.float32 if value.is_floating_point()
                else value.dtype)
            return self._buffers[name]

    def update(self, name: str, fn) -> torch.Tensor:
        with self._locks[name]:
            b = self._buffers[name]
            out = fn(b)
            self._buffers[name] = out if out.dtype == b.dtype \
                else out.to(b.dtype)
            return self._buffers[name]

    def names(self):
        return list(self._buffers)


def _variable(ctx, attrs):
    name = attrs["var_name"]
    ctx.task.var_store.ensure(name, attrs.get("initial"))
    return (VarHandle(name, ctx.task.var_store),)


def _read(ctx, attrs, handle):
    return (handle.store.read(handle.name),)


def _assign(ctx, attrs, handle, value):
    return (handle.store.assign(handle.name, value),)


def _assign_add(ctx, attrs, handle, value):
    return (handle.store.update(handle.name, lambda b: b + value),)


def _assign_sub(ctx, attrs, handle, value):
    return (handle.store.update(handle.name, lambda b: b - value),)


def _scatter(sign):
    def compute(ctx, attrs, handle, ids, rows):
        def fn(b):
            flat, vals = scatter_rows(ids, rows, b.shape[0])
            b.index_add_(0, flat, vals.to(b.dtype), alpha=sign)
            return b
        return (handle.store.update(handle.name, fn),)
    return compute


register(OpDef("Variable", 1, _variable, stateful=True))
register(OpDef("Read", 1, _read, stateful=True))
register(OpDef("Assign", 1, _assign, stateful=True))
register(OpDef("AssignAdd", 1, _assign_add, stateful=True))
register(OpDef("AssignSub", 1, _assign_sub, stateful=True))
register(OpDef("ScatterAdd", 1, _scatter(1), stateful=True))
register(OpDef("ScatterSub", 1, _scatter(-1), stateful=True))


# ---------------------------------------------------------------------------
# checkpointing ops (§4.3)
# ---------------------------------------------------------------------------


def _save(ctx, attrs, *handles):
    arrays = {h.name: h.store.read(h.name).cpu().numpy() for h in handles}
    np.savez(attrs["path"], **arrays)
    return ()


def _restore(ctx, attrs):
    path = str(attrs["path"])
    data = np.load(path if path.endswith(".npz") else path + ".npz")
    return (torch.from_numpy(data[attrs["tensor_name"]]).to(
        ctx.task.device),)


register(OpDef("Save", 0, _save, stateful=True))
register(OpDef("Restore", 1, _restore, stateful=True))

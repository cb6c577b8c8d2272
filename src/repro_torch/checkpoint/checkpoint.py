"""User-level checkpointing (port of ``repro.checkpoint.checkpoint``,
paper §4.3).

As in the JAX package: library code over save and restore, with the
retention, best-metric and cadence policies in the caller's hands; one
writer, one ``manifest.json`` and one ``.npy`` per flattened leaf in a
``step_%08d`` directory; a checkpoint is consistent when the caller takes
it between synchronous steps (the trainer does). The format is the JAX
package's, byte for byte: leaves are named by their path ("params/
layers/0/attn/wq"), bf16 leaves are stored as their uint16 view with
``"dtype": "bfloat16"`` in the manifest, and either package reads the
other's checkpoints.

``save`` copies every leaf to the host before it returns (so the caller
may update its tensors in place at once) and writes the files on a
thread; ``restore`` returns CPU tensors of the saved dtypes in the
structure of a prototype tree (``checkpoint.elastic.restore_to`` places
them on a device).
"""

from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: dict, spec):
    if isinstance(spec, dict):
        return {k: _unflatten(
            {p[len(k) + 1:]: v for p, v in flat.items()
             if p.split("/")[0] == k}, spec[k]) for k in spec}
    if isinstance(spec, (list, tuple)):
        vals = [
            _unflatten({p[len(str(i)) + 1:]: v for p, v in flat.items()
                        if p.split("/")[0] == str(i)}, s)
            for i, s in enumerate(spec)]
        return type(spec)(vals)
    if len(flat) != 1:
        raise KeyError(f"checkpoint leaves {sorted(flat)} do not match one "
                       "leaf of the prototype")
    return next(iter(flat.values()))


def _host(x, copy: bool = True) -> tuple[np.ndarray, str]:
    """(a numpy copy of the leaf that owns its memory, its logical dtype
    name): a bf16 tensor as its uint16 view, named "bfloat16". A host
    tensor is taken as it is with ``copy=False``."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        elif copy:
            t = t.clone()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
        return a, str(a.dtype)
    a = np.array(x)
    if a.dtype.name == "bfloat16":          # an ml_dtypes array
        return a.view(np.uint16), "bfloat16"
    return a, str(a.dtype)


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3,
                 keep_best: int = 0, async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.keep_best = keep_best
        self.async_save = async_save
        self._pending: threading.Thread | None = None
        self._scores: dict[int, float] = self._load_scores()

    # -- save -----------------------------------------------------------------

    def save(self, step: int, state, metric: float | None = None,
             copy: bool = True):
        """state: a tree (dicts, lists, tuples) of tensors or arrays. A
        blocking host copy of every leaf, then the disk write on a thread
        (the next step may run while it drains), or before returning
        with ``async_save=False``. ``copy=False``: the caller hands over
        host tensors it will not change, written without a copy."""
        flat = {k: _host(v, copy) for k, v in _flatten(state).items()}
        if self._pending is not None:
            self._pending.join()

        def write():
            path = self.dir / f"step_{step:08d}"
            tmp = self.dir / f".tmp_{step:08d}_{time.time_ns()}"
            tmp.mkdir(parents=True)
            manifest = {}
            for name, (arr, logical) in flat.items():
                fn = name.replace("/", "__") + ".npy"
                np.save(tmp / fn, arr)
                manifest[name] = {"file": fn, "shape": list(arr.shape),
                                  "dtype": logical}
            (tmp / "manifest.json").write_text(json.dumps(
                {"step": step, "metric": metric, "leaves": manifest}))
            if path.exists():
                shutil.rmtree(path)
            tmp.rename(path)
            if metric is not None:
                self._scores[step] = metric
                self._save_scores()
            self._gc()

        if self.async_save:
            self._pending = threading.Thread(target=write, daemon=True)
            self._pending.start()
        else:
            write()

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    # -- restore ----------------------------------------------------------------

    def steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob(
            "step_*"))

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, spec, step: int | None = None,
                mmap: bool = False) -> tuple[int, dict]:
        """spec: a prototype tree (its structure is used, not its leaves).
        Returns (step, the tree of CPU tensors of the saved dtypes);
        ``step`` defaults to the latest. ``mmap``: the tensors are
        copy-on-write maps of the files, read as they are used (a
        rank that cuts its shards reads only those)."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = self.dir / f"step_{step:08d}"
        manifest = json.loads((path / "manifest.json").read_text())
        mode = "c" if mmap else None
        flat = {name: _tensor(np.load(path / meta["file"], mmap_mode=mode),
                              meta["dtype"])
                for name, meta in manifest["leaves"].items()}
        return step, _unflatten(flat, spec)

    # -- retention ---------------------------------------------------------------

    def _gc(self):
        steps = self.steps()
        protected: set[int] = set(steps[-self.keep:]) if self.keep else set()
        if self.keep_best and self._scores:
            best = sorted(self._scores, key=self._scores.get)
            protected.update(best[:self.keep_best])
        for s in steps:
            if s not in protected:
                shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    def _load_scores(self):
        f = self.dir / "scores.json"
        if f.exists():
            return {int(k): v for k, v in json.loads(f.read_text()).items()}
        return {}

    def _save_scores(self):
        (self.dir / "scores.json").write_text(json.dumps(self._scores))

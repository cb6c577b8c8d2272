"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``src/repro_torch/csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a``
into its own shared library with a plain C interface; ``*.cuh`` headers
there are shared between sources. The libraries land in
``build/repro_torch/<hash>/`` at the repo root, keyed by a hash of the
sources, headers and flags, so an edited source rebuilds and an unchanged
one loads at once. All ``nvcc`` processes start together. Nothing here runs
at import: the CPU tests import every module of the package, and this
host may have no ``nvcc``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (looked on PATH and /usr/local/cuda/bin)")
    return path


def build_dir() -> Path:
    """The directory the current sources build into."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):          # sources and headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict[str, Path]:
    """Compile every source that has no library yet, one ``nvcc`` each, all
    in parallel. Returns {source stem: library path}. Raises with the
    compiler's output when a build fails. ``build.log`` in the build
    directory keeps ptxas' register and shared-memory report."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {src.stem: out_dir / f"lib{src.stem}.so"
            for src in sorted(CSRC.glob("*.cu"))}
    nvcc = None
    procs = []
    for stem, lib in libs.items():
        if lib.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        procs.append((stem, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs = []
    failed = []
    for stem, lib, tmp, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {stem}.cu ==\n{out}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {stem}.cu:\n{out}")
        else:
            os.replace(tmp, lib)
    if logs:
        with open(out_dir / "build.log", "a") as f:
            f.write("\n".join(logs))
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def load(stem: str, signatures: dict | None = None) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built if needed).
    ``signatures`` ({function: (argtypes, restype)}) are set once, when the
    library is first loaded."""
    lib = _loaded.get(stem)
    if lib is None:
        lib = ctypes.CDLL(str(build_all()[stem]))
        for name, (argtypes, restype) in (signatures or {}).items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        _loaded[stem] = lib
    return lib


def current_stream(t) -> int:
    """PyTorch's current CUDA stream on ``t``'s device, as a handle (read
    without building a ``torch.cuda.Stream``, which costs microseconds per
    launch on the host)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def on_device(t):
    """A context making ``t``'s card the current one (kernels launch on the
    current card), entered only when it is not already."""
    if t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)

"""The engine's compiled steps: each (step shape, sampling mode) captured
once as a CUDA graph and replayed (the port of the JAX engine's jitted
step executables: ``_step_chunk`` and ``_step_plain``, and the
full-sampling pair ``_full_steps`` it compiles at first use, in
``repro.serving.engine``).

A runner's step body has two shapes per engine, with and without the
chunk row, at fixed tensor shapes, and three sampling modes
(``runners.SAMPLING_MODES``): "greedy" (the argmax, no noise), "plain"
(temperature and top-k rows drawn in the body) and "full" (the whole
pipeline). The engine picks the mode on the host from the scheduled
requests, a generalisation of the JAX engine's switch between its plain
and full executables: a greedy step gets a graph that draws no noise,
since the threefry noise of (B + S) x V_pad words costs real time. The
body reads only device tensors. On the card :class:`CompiledSteps`
captures each (shape, mode) lazily, at its first step, as ``jax.jit``
compiles on first call, following PyTorch's recipe:

1. a null step into the engine's input buffers (no decode slot active, an
   empty chunk that does not start its sequence), which changes no state
   but the trash block's;
2. the body run eagerly ``WARMUP_STEPS`` times on a side stream on that
   null step, so that the kernels' first-use builds, their attribute
   calls and cuBLAS's lazy handles happen outside capture;
3. the capture, into one memory pool shared by all the engine's graphs:
   they never run at once, and each graph's outputs are read right after
   its own replay, before another can reuse the memory.

A capture that fails raises; nothing falls back to the eager body. The
cyclic garbage collector is run before a capture and kept off during it:
a dead graph it freed there would destroy its executable while the
stream captures, which invalidates the capture.

Several engines may share a card, each stepped by its own thread (the
data-parallel replicas of ``serving.router``), and one may meet a new
(shape, mode) mid-run. Their device work is serialized: each engine
holds the process-wide ``DEVICE_LOCK`` through a step (and a capture), so
a capture never runs beside another thread's launches, copies or
allocations; each engine runs on a stream of its own and captures in the
thread-local error mode besides. (Two engines stepping freely on one card
hung there, both threads waiting on the device, in the first runs of
``chip_smoke.py`` phase 11d.)

Kernel wrappers count launches in Python, which a replay never runs. Each
capture records the launches its body made (the counters' delta over the
capture); a run's launches are then the counters' own (warm-up and
capture) plus, per (shape, mode), replays x launches per capture
(:func:`replayed_launches`).

No graph is captured under tensor parallelism (a current model group of
more than one rank, ``spmd.collectives``): capturing the group's
collectives is not ported (ROADMAP.md queue 1 item 12), and a
tensor-parallel engine runs eagerly.
"""

from __future__ import annotations

import gc
import threading
from collections import Counter

import torch

from repro_torch.kernels import embedding as emb
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import sampled_softmax as ss
from repro_torch.kernels import ssd as ssd_k
from repro_torch.spmd import collectives

__all__ = ["CompiledSteps", "KERNELS", "launch_counts", "replayed_launches"]

WARMUP_STEPS = 2
# one engine's device work at a time in the process (see the module
# docstring); reentrant: a step captures its graph under it
DEVICE_LOCK = threading.RLock()
# every kernel wrapper: ``.launches`` is a Counter by variant (pool dtype
# or route) or an int
KERNELS = (pa.paged_attention, pa.paged_prefill_attention,
           pa.ragged_paged_prefill_attention, emb.gather, ssd_k.ssd,
           fa.flash_attention, ss.sampled_softmax_loss)


def launch_counts() -> Counter:
    """Every kernel wrapper's launches so far, keyed (wrapper name,
    variant); the variant is "" for a wrapper that keeps one count."""
    out = Counter()
    for fn in KERNELS:
        if isinstance(fn.launches, dict):
            for variant, n in fn.launches.items():
                out[fn.__name__, variant] += n
        else:
            out[fn.__name__, ""] += fn.launches
    return out


def replayed_launches(per_capture: dict, replays: dict) -> Counter:
    """Launches made by replays: for each graph key, its replays times the
    launches one capture of it recorded. ``per_capture``: {key: {kernel:
    launches}}; ``replays``: {key: replays}."""
    out = Counter()
    for shape, n in replays.items():
        for kernel, k in per_capture.get(shape, {}).items():
            out[kernel] += n * k
    return out


class CompiledSteps:
    """One CUDA graph per (step shape, sampling mode) of one engine.

    ``body(has_chunk=..., sampling=...)`` runs the step body on the
    engine's input buffers and returns its outputs; ``null_step()`` fills
    those buffers with a step that changes no state but the trash block.
    Neither may hold the engine: the engine then stays free of reference
    cycles, and its graphs (and their memory pool) go with its last
    reference. The engine calls :meth:`capture` before it fills a key's
    first real inputs, then :meth:`replay` on every step of that key. A
    key is ``(has_chunk, mode)``."""

    def __init__(self, body, null_step, device):
        self.body = body
        self.null_step = null_step
        self.device = torch.device(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs = {}                 # key -> CUDAGraph
        self.outputs = {}                # key -> the body's outputs
        self.launches = {}               # key -> Counter per replay
        self.replays = Counter()         # key -> replays

    def __contains__(self, key) -> bool:
        return key in self.graphs

    def capture(self, key) -> None:
        """Warm up on a null step, then capture the key's graph."""
        has_chunk, mode = key
        group = collectives.current()
        if group is not None and group.size > 1:
            raise NotImplementedError(
                "CUDA graphs of a tensor-parallel step (collectives under "
                "capture) are not ported yet (ROADMAP.md queue 1 item 12)")
        with DEVICE_LOCK:
            self._capture(key, has_chunk, mode)

    def _capture(self, key, has_chunk, mode) -> None:
        gc.collect()
        with torch.cuda.device(self.device), torch.no_grad():
            self.null_step()
            main = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(main)
            with torch.cuda.stream(side):
                for _ in range(WARMUP_STEPS):
                    self.body(has_chunk=has_chunk, sampling=mode)
            main.wait_stream(side)
            g = torch.cuda.CUDAGraph(keep_graph=True)
            before = launch_counts()
            gc.disable()
            try:
                with torch.cuda.graph(g, pool=self.pool,
                                      capture_error_mode="thread_local"):
                    out = self.body(has_chunk=has_chunk, sampling=mode)
            finally:
                gc.enable()
            self.launches[key] = launch_counts() - before
            g.instantiate()
            # the null step's upload has finished: the host may refill
            # the staging area
            main.synchronize()
        self.graphs[key] = g
        self.outputs[key] = out

    def replay(self, key):
        """Run the key's graph on the current stream; returns its output
        tensors (valid until the next replay of any key)."""
        self.graphs[key].replay()
        self.replays[key] += 1
        return self.outputs[key]

    def run_launches(self) -> Counter:
        """Kernel launches made by this engine's replays so far."""
        return replayed_launches(self.launches, self.replays)

    def pool_bytes(self) -> int:
        """Device bytes held by the graphs' memory pool."""
        pool = tuple(self.pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) == pool)

#!/usr/bin/env python3
"""Time greedy mamba2_370m serving on CUDA graphs in two source trees on one
card, in turns.

  python3 tools/serve_ab.py OTHER_ROOT    # from the repo root; one CUDA card

OTHER_ROOT is another copy of the repo (for example a parent commit
unpacked with ``git archive`` into a directory that .gitignore lists). The
two trees run in the order other, this, this, other, each in a process of
its own that builds that tree's kernels (into that tree's build/) and
serves chip_smoke.py's phase-5 mamba2 run with that tree's engine: full
width and depth, random weights from seed 0, max_batch 8, a 264-token
budget, 8 greedy requests of 512 tokens, 32 new each, both graphs captured
up front. Each process serves it three times (a fresh engine each time)
and reports per run: tok/s, the mean wall of decode and chunk steps (each
shape's first step left out) and the device time of one decode graph
replay (CUDA events over 20 replays after the run), so that the host's
share of a decode step is the step's wall less its replay. Prints the
card's name and power limit, one JSON line per process, and each tree's
means.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REPEATS, REPLAYS = 3, 20


def serve_once(torch, cfg, params, prompts):
    from repro_torch.serving import InferenceEngine, Request

    eng = InferenceEngine(cfg, device="cuda", params=params, max_batch=8,
                          block_size=16, max_len=1024,
                          max_num_batched_tokens=8 + 256, seed=0,
                          cuda_graphs=True)
    eng.capture_graphs()
    walls = {True: [], False: []}
    shape = [None]
    schedule, step = eng.sched.schedule, eng.step

    def counted_schedule():
        plan = schedule()
        shape[0] = bool(plan.chunks) if plan.scheduled_tokens else None
        return plan

    def timed_step():
        t = time.monotonic()
        out = step()
        if shape[0] is not None:
            walls[shape[0]].append(time.monotonic() - t)
        return out

    eng.sched.schedule, eng.step = counted_schedule, timed_step
    reqs = [Request(p.copy(), max_new=32) for p in prompts]
    torch.cuda.synchronize()
    eng.run(reqs)
    torch.cuda.synchronize()
    # the decode graph: keyed False in one-mode engines, (False, "greedy")
    # where graphs are keyed by (shape, sampling mode)
    key = next(k for k in eng.graphs.graphs
               if (k[0] if isinstance(k, tuple) else k) is False)
    g = eng.graphs.graphs[key]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPLAYS):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return {"tok_s": eng.stats["tok_s"],
            "decode_step_ms": 1e3 * statistics.mean(walls[False][1:]),
            "chunk_step_ms": 1e3 * statistics.mean(walls[True][1:]),
            "decode_replay_device_ms": start.elapsed_time(end) / REPLAYS}


def child(tree: Path) -> None:
    sys.path.insert(0, str(tree / "src"))
    import numpy as np
    import torch

    from repro_torch.config import get_config
    from repro_torch.kernels import build
    from repro_torch.models.api import init_model

    assert Path(build.__file__).resolve().is_relative_to(tree.resolve())
    build.build_all()
    cfg = get_config("mamba2_370m")
    params = init_model(cfg, 0, "cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 512).astype(np.int32)
               for _ in range(8)]
    runs = [serve_once(torch, cfg, params, prompts) for _ in range(REPEATS)]
    print(json.dumps({"tree": str(tree), "runs": runs}), flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        child(Path(sys.argv[2]))
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    out = {}
    for tree in (other, ROOT, ROOT, other):
        p = subprocess.run([sys.executable, __file__, "--child", str(tree)],
                           capture_output=True, text=True)
        if p.returncode:
            print(p.stdout + p.stderr, file=sys.stderr)
            return p.returncode
        line = p.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        out.setdefault(str(tree), []).extend(json.loads(line)["runs"])
    for tree, runs in out.items():
        print(json.dumps({"tree": tree, "mean": {
            k: statistics.mean(r[k] for r in runs) for k in runs[0]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

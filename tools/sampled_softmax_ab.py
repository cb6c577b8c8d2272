#!/usr/bin/env python3
"""Time the sampled-softmax loss kernel of two source trees on one card,
in turns.

  python3 tools/sampled_softmax_ab.py OTHER_ROOT   # from the repo root

OTHER_ROOT is another copy of the repo (for example a parent commit
unpacked with ``git archive`` into a directory that .gitignore lists). The
two trees run in the order other, this, this, other, each in a process of
its own that builds that tree's kernels (into that tree's build/) and
times its ``repro_torch.kernels.sampled_softmax.sampled_softmax_loss`` at
chip_smoke.py's phase 2e main shape: glm4_9b's 151552 x 4096 bf16 head,
T = 4096 rows, n = 8192 sampled ids, no cap, inputs from seed 0, with
chip_smoke's Timer (CUDA events and profiler device time, the L2 cache
flushed before every call; the two gathers included). Needs one CUDA
card. Prints the card's name and power limit, one JSON line per run (the
loss too: both trees must compute the same function), and the mean of
each tree's two runs.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def child(tree: Path) -> None:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(tree / "src"))
    import torch

    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels import sampled_softmax as ss

    assert Path(ss.__file__).resolve().is_relative_to(tree.resolve())
    build.build_all()
    timer = chip_smoke.Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    V, d, n, T = chip_smoke.SAMPLED_SHAPE
    table, sids, x, labels = chip_smoke.sampled_inputs(torch, gen, V, d, n,
                                                       T)

    def run():
        return ss.sampled_softmax_loss(x, table, labels, sids)

    print(json.dumps({"tree": str(tree), "loss": float(run()),
                      "ms": timer(run), "device_ms": timer.device(run),
                      "device_ms_by_kernel": timer.kernels(run)}),
          flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        child(Path(sys.argv[2]))
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    other = Path(sys.argv[1]).resolve()
    print(chip_smoke.card_line(), flush=True)
    runs = []
    for tree in (other, ROOT, ROOT, other):
        r = subprocess.run([sys.executable, __file__, "--child", str(tree)],
                           capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            print(r.stdout, r.stderr, file=sys.stderr)
            return 1
        runs.append(json.loads(r.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    for tree in (other, ROOT):
        mine = [r for r in runs if r["tree"] == str(tree)]
        means = {k: sum(r[k] for r in mine) / len(mine)
                 for k in ("ms", "device_ms")}
        print(json.dumps({"tree": str(tree), "mean": means}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

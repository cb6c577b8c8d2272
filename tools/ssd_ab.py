#!/usr/bin/env python3
"""Time the SSD scan kernel of two source trees on one card, in turns.

  python3 tools/ssd_ab.py OTHER_ROOT      # from the repo root; one CUDA card

OTHER_ROOT is another copy of the repo (for example a parent commit
unpacked with ``git archive`` into a directory that .gitignore lists). The
two trees run in the order other, this, this, other, each in a process of
its own that builds that tree's kernels (into that tree's build/) and
times its ``repro_torch.kernels.ssd.ssd`` at chip_smoke.py's phase 2c
shapes: b = 1, S = Q = 256, h0 given, at mamba2_370m's widths (nh 32, hp
64, N 128) and zamba2_2p7b's (nh 80, hp 64, N 64), inputs from seed 0,
with chip_smoke's Timer (CUDA events and profiler device time, the L2
cache flushed before every call). Prints the card's name and power limit,
one JSON line per run, and the mean of each tree's two runs.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WIDTHS = {"mamba2_370m": (32, 64, 1, 128), "zamba2_2p7b": (80, 64, 1, 64)}
Q = 256


def child(tree: Path) -> None:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(tree / "src"))
    import torch

    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels import ssd as ssd_k

    assert Path(ssd_k.__file__).resolve().is_relative_to(tree.resolve())
    build.build_all()
    timer = chip_smoke.Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    out = {"tree": str(tree)}
    for arch, (nh, hp, G, N) in WIDTHS.items():
        x, dt, A, B, C, h0 = chip_smoke.ssd_inputs(torch, gen, 1, Q, nh, hp,
                                                   G, N)

        def run():
            return ssd_k.ssd(x, dt, A, B, C, chunk=Q, h0=h0)

        out[f"{arch}_ms"] = timer(run)
        out[f"{arch}_device_ms"] = timer.device(run)
        out[f"{arch}_device_ms_by_kernel"] = timer.kernels(run)
    print(json.dumps(out), flush=True)


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
        means = {k: sum(r[k] for r in mine) / len(mine) for k in mine[0]
                 if k.endswith("_ms")}
        print(json.dumps({"tree": str(tree), "mean": means}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

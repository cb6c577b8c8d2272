#!/usr/bin/env python3
"""Time the paged decode and chunk kernels of two source trees on one
card, in turns.

  python3 tools/paged_ab.py OTHER_ROOT    # from the repo root; one CUDA card

OTHER_ROOT is another copy of the repo (for example a parent commit
unpacked with ``git archive`` into a directory that .gitignore lists). The
two trees run in the order other, this, this, other, each in a process of
its own that builds that tree's kernels (into that tree's build/) and
times its ``repro_torch.kernels.paged_attention`` wrappers at chip_smoke
phase 2a's glm4_9b shapes (H 32, K 2, hd 128, 16-token pages: decode over
8 sequences up to 2048 tokens, one 256-row chunk ending at 2048 keys)
over bf16 and int8 pools, inputs from seed 0, with chip_smoke's Timer
(CUDA events, and profiler device time, the L2 cache flushed before every
call). Prints the card's name and power limit, one JSON line per run, and
the mean of each tree's two runs.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
H, K, HD, BS = 32, 2, 128, 16
DECODE_CTX = [2048, 1536, 1024, 777, 2000, 1, 0, 300]
CHUNK = (256, 200, 2048)          # rows, valid rows, keys at its end


def child(tree: Path) -> None:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(tree / "src"))
    import torch

    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels import paged_attention as pa

    assert Path(pa.__file__).resolve().is_relative_to(tree.resolve())
    build.build_all()
    timer = chip_smoke.Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    nb = 2048 // BS
    dec = chip_smoke.paged_case(torch, gen, len(DECODE_CTX), H, K, HD, BS,
                                nb, DECODE_CTX)
    C, qlen, ctx = CHUNK
    chk = chip_smoke.paged_case(torch, gen, 1, H, K, HD, BS, nb, [ctx], C=C)
    ql = torch.tensor([qlen], dtype=torch.int32, device="cuda")
    out = {"tree": str(tree)}
    for kv in ("bf16", "int8"):
        for name, (q, kp16, vp16, bt, ctxt) in (("decode", dec),
                                                ("chunk", chk)):
            kp, vp, sc = chip_smoke.pools_in(kv, kp16, vp16)
            if name == "decode":
                def fn():
                    return pa.paged_attention(q, kp, vp, bt, ctxt, **sc)
            else:
                def fn():
                    return pa.paged_prefill_attention(q, kp, vp, bt, ctxt,
                                                      ql, **sc)
            d = {"ms": timer(fn)}
            # the profiler now and then records no kernel: trace again
            for _ in range(3):
                d["device_ms"] = timer.device(fn)
                if d["device_ms"]:
                    break
            out[f"{name}_{kv}"] = d
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
        means = {name: {k: sum(r[name][k] for r in mine) / len(mine)
                        for k in mine[0][name]}
                 for name in mine[0] if name != "tree"}
        print(json.dumps({"tree": str(tree), "mean": means}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

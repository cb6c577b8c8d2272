#!/usr/bin/env python3
"""Time the flash attention forward of two source trees on one card, in
turns.

  python3 tools/flash_ab.py OTHER_ROOT    # from the repo root; one CUDA card

OTHER_ROOT is another copy of the repo (for example a parent commit
unpacked with ``git archive`` into a directory that .gitignore lists). The
two trees run in the order other, this, this, other, each in a process of
its own that builds that tree's kernels (into that tree's build/) and
times its ``repro_torch.kernels.flash_attention.flash_attention`` at
SHAPES (zamba2's shared block at hd 80, whisper's attention at hd 64,
glm4's at hd 128, the mma route's hd 8-16), inputs from seed 0, with chip_smoke's Timer (CUDA
events, and profiler device time, the L2 cache flushed before every call),
beside ``scaled_dot_product_attention`` on the same inputs under both
timers. Prints the card's name and power limit, one JSON line per run,
and the mean of each tree's two runs.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# name: B, Sq, Skv, H, K, hd, causal
SHAPES = {
    "zamba2_causal_b2_s2048": (2, 2048, 2048, 32, 32, 80, True),
    "zamba2_causal_b8_s512": (8, 512, 512, 32, 32, 80, True),
    "whisper_encoder_1500": (1, 1500, 1500, 20, 20, 64, False),
    "whisper_encoder_b8_1500": (8, 1500, 1500, 20, 20, 64, False),
    "whisper_cross_256x1500": (1, 256, 1500, 20, 20, 64, False),
    "whisper_causal_b8_s512": (8, 512, 512, 20, 20, 64, True),
    "glm4_causal_b2_s2048": (2, 2048, 2048, 32, 2, 128, True),
    # the mma route (hd 8, 12, 16: the smoke configs) at chip_smoke phase
    # 2h's shapes
    "smoke_hd16_causal_s300": (2, 300, 300, 4, 2, 16, True),
    "smoke_hd8_causal_s300": (2, 300, 300, 4, 2, 8, True),
    "smoke_hd12_causal_s300": (2, 300, 300, 4, 2, 12, True),
    "smoke_hd8_noncausal_130x200": (2, 130, 200, 4, 2, 8, False),
}


def child(tree: Path) -> None:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(tree / "src"))
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    assert Path(fa.__file__).resolve().is_relative_to(tree.resolve())
    build.build_all()
    timer = chip_smoke.Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    out = {"tree": str(tree)}
    for name, (B, Sq, Skv, H, K, hd, causal) in SHAPES.items():
        q = torch.randn((B, Sq, H, hd), generator=gen,
                        device="cuda").bfloat16()
        k, v = (torch.randn((B, Skv, K, hd), generator=gen,
                            device="cuda").bfloat16() for _ in range(2))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        pairs = chip_smoke.causal_pairs(Sq, Skv, causal, None, 0)
        flops = 4.0 * B * H * hd * pairs
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) \
            + 4 * B * Sq * H
        fns = {"": lambda: fa.flash_attention(q, k, v, causal=causal),
               "sdpa_": lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=causal, enable_gqa=H != K)}
        d = {"route": fa.route(hd), "bound_ms": chip_smoke.bound_ms(
            nbytes, flops)[0], "gflop": flops / 1e9}
        for key, fn in fns.items():
            d[key + "ms"] = timer(fn)
            # the profiler now and then records no kernel: trace again
            for _ in range(3):
                d[key + "device_ms"] = timer.device(fn)
                if d[key + "device_ms"] > 0:
                    break
            d[key + "tflops"] = flops / max(d[key + "device_ms"],
                                            1e-9) * 1e-9
        out[name] = d
        del q, k, v, qt, kt, vt
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
                        for k, x in mine[0][name].items()
                        if isinstance(x, float)}
                 for name in SHAPES}
        print(json.dumps({"tree": str(tree), "mean": means}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time the flash kernel's hd-64 and hd-80 callers end to end in two
source trees on one card, in turns.

  python3 tools/slice_ab.py OTHER_ROOT [--serve-only]   # repo root; one card

OTHER_ROOT is another copy of the repo (for example a parent commit
unpacked with ``git archive`` into a directory that .gitignore lists). The
two trees run in the order other, this, this, other, each in a process of
its own that builds that tree's kernels and imports that tree's
``chip_smoke``: whisper_large_v3's encode of one request (32 encoder
layers at full width, random weights from seed 0, seeded 1500 x 1280
frames; CUDA events and profiler device time, the L2 cache flushed before
each call), phase 12c's whisper serving run (``serve_whisper``: 8
requests on CUDA graphs and eager; the graphs' tok/s, TTFT and token gap)
with how many of its 8 requests the static path (``generate_static``)
and the preempting 41-block run give token for token as the engine, and
phase 13's training runs of zamba2_2p7b and whisper_large_v3
(``train_families``: 4 AdamW steps, step ms the mean of steps 2-4; left
out with ``--serve-only``). Prints the card's name and power limit, one
JSON line per run, and the mean of each tree's two runs.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TRAIN = ["zamba2_2p7b", "whisper_large_v3"]


def child(tree: Path, train: bool) -> None:
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.config import get_config
    from repro_torch.kernels import build
    from repro_torch.models import encdec
    from repro_torch.models.api import init_model
    from repro_torch.serving.graphs import KERNELS

    assert Path(cs.__file__).resolve().is_relative_to(tree.resolve())
    # as chip_smoke's main: fp32 products stay fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    out = {"tree": str(tree)}
    cfg = get_config("whisper_large_v3")
    params = init_model(cfg, 0, "cuda")
    frames = np.random.default_rng(0).normal(
        0, 1, (1, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    fr = torch.from_numpy(frames).to("cuda", torch.bfloat16)
    timer = cs.Timer(torch)
    with torch.no_grad():
        def encode():
            return encdec.encode_cross_kv(params, fr, cfg)

        out["whisper_encode_ms"] = timer(encode, iters=10)
        out["whisper_encode_device_ms"] = timer.device(encode, iters=5)
    del params, timer, fr
    torch.cuda.empty_cache()
    graphs, _, static, tight = cs.serve_whisper(torch, KERNELS,
                                                cs.card_line(), {})
    out["whisper_static_identical"] = static["identical"]
    out["whisper_static_margins"] = static["margins"]
    out["whisper_preempted_identical"] = tight["identical"]
    for key in ("tok_s", "ttft_s_median", "ttft_s_max", "token_gap_s_median",
                "chunk_step_ms_mean", "decode_step_ms_mean",
                "chunk_body_device_ms_mean"):
        out[f"whisper_serve_{key}"] = float(graphs[key])
    for res in (cs.train_families(torch, KERNELS, cs.card_line(), TRAIN)
                if train else []):
        out[f"{res['arch']}_step_ms"] = res["step_ms_mean"]
        out[f"{res['arch']}_launches"] = res["launches"]
    print(json.dumps(out), flush=True)


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--child"]:
        child(Path(args[1]), "--serve-only" not in args)
        return 0
    flags = [a for a in args if a.startswith("--")]
    if len(args) - len(flags) != 1 or set(flags) - {"--serve-only"}:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    other = Path(next(a for a in args if a not in flags)).resolve()
    print(chip_smoke.card_line(), flush=True)
    runs = []
    for tree in (other, ROOT, ROOT, other):
        r = subprocess.run([sys.executable, __file__, "--child", str(tree),
                            *flags], capture_output=True, text=True,
                           timeout=1200)
        if r.returncode != 0:
            print(r.stdout[-4000:], r.stderr[-4000:], file=sys.stderr)
            return 1
        runs.append(json.loads(r.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    for tree in (other, ROOT):
        mine = [r for r in runs if r["tree"] == str(tree)]
        means = {k: sum(r[k] for r in mine) / len(mine)
                 for k, x in mine[0].items() if isinstance(x, float)}
        print(json.dumps({"tree": str(tree), "mean": means}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
